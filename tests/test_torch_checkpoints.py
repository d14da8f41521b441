"""The port's checkpoints (latest / best / named, restore) and the training
loop's resume, on a toy model and on the micro pipeline."""

import os

import numpy as np
import pytest
import torch
from torch import nn

from guava_renderer_tpu_torch import testing as ttesting
from guava_renderer_tpu_torch.cli.trainer_loop import (
    MovingAverageMeter, eval_metrics_fn, run_validation, train_on_batches)
from guava_renderer_tpu_torch.train.checkpoints import CheckpointManager
from guava_renderer_tpu_torch.train.pipeline import make_loss_fn
from guava_renderer_tpu_torch.train.trainstep import make_train_state, make_train_step

torch.set_num_threads(2)


def _toy_state(seed=0):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
    return make_train_state(model, learning_rate=1e-2)


def _toy_steps(state, n):
    x = torch.arange(12.0).reshape(4, 3) / 10

    def loss_fn(batch, iteration):
        loss = (state.model(batch) ** 2).mean()
        return loss, {"loss": loss}

    step = make_train_step(loss_fn, state)
    for _ in range(n):
        step(x)


def test_save_latest_and_restore(tmp_path):
    state = _toy_state()
    _toy_steps(state, 3)
    ckpts = CheckpointManager(str(tmp_path))
    path = ckpts.save_latest(state, 3)
    assert os.path.basename(path) == "latest.pt" and ckpts.find_checkpoint() == path
    other = _toy_state(seed=1)
    restored, it = ckpts.restore(other)
    assert it == 3 and restored is other and other.iteration == 3
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    # the optimizer's moments came along: both take the same next step
    _toy_steps(state, 1)
    _toy_steps(other, 1)
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)


def test_best_replaces_the_old_best_and_wins_over_latest(tmp_path):
    state = _toy_state()
    ckpts = CheckpointManager(str(tmp_path))
    assert ckpts.best_ssim() == -1.0 and ckpts.find_checkpoint() is None
    ckpts.save_best(state, 10, 0.5)
    ckpts.save_latest(state, 20)
    ckpts.save_best(state, 30, 0.625)
    names = sorted(os.listdir(ckpts.dir))
    assert names == ["best_30_0.6250.pt", "latest.pt"]
    assert ckpts.best_ssim() == pytest.approx(0.625)
    assert os.path.basename(ckpts.find_checkpoint()) == "best_30_0.6250.pt"


def test_named_snapshot_and_missing(tmp_path):
    state = _toy_state()
    ckpts = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpts.restore(state)
    path = ckpts.save_named("iter_7", state, 7)
    assert os.path.basename(path) == "iter_7.pt"
    assert ckpts.find_checkpoint() is None           # a named snapshot is found only by name
    _, it = ckpts.restore(_toy_state(seed=2), path)
    assert it == 7
    assert not [f for f in os.listdir(ckpts.dir) if f.endswith(".tmp")]


def test_moving_average_meter():
    m = MovingAverageMeter(window=2)
    for v in (1.0, 2.0, 4.0):
        m.update({"loss": torch.tensor(v), "k": v})
    assert m.averages() == {"loss": 3.0, "k": 3.0}
    assert m.format() == "k=3.0000 loss=3.0000"


@pytest.fixture(scope="module")
def micro_run(tmp_path_factory):
    """Three steps of the micro pipeline through `train_on_batches` (the inner
    loop of `run_training`), then a resumed run to step 5."""
    run_dir = str(tmp_path_factory.mktemp("run"))
    tp = ttesting.make_micro_pipeline(batch_size=1, device="cpu")
    model = nn.ModuleDict({"inferer": tp.statics.inferer, "renderer": tp.statics.renderer})
    state = make_train_state(model, learning_rate=1e-3)
    loss_fn = make_loss_fn(tp.statics, None)
    lines, seen = [], []
    train_on_batches(state, loss_fn, tp.statics, [tp.batch], 3, run_dir, valid_batches=[tp.batch],
                 check_interval=2, log_every=1, count_scrubbed=True,
                 on_step=lambda it, loss, metrics: seen.append((it, float(loss))),
                 log=lines.append)
    after3 = {n: p.detach().clone() for n, p in model.named_parameters()}

    tp2 = ttesting.make_micro_pipeline(batch_size=1, seed=5, device="cpu")   # other weights
    model2 = nn.ModuleDict({"inferer": tp2.statics.inferer, "renderer": tp2.statics.renderer})
    state2 = make_train_state(model2, learning_rate=1e-3)
    lines2, seen2 = [], []
    train_on_batches(state2, make_loss_fn(tp2.statics, None), tp2.statics, [tp.batch], 5, run_dir,
                 resume=os.path.join(run_dir, "checkpoints", "latest.pt"), log_every=1,
                 on_step=lambda it, loss, metrics: seen2.append(it), log=lines2.append)
    return dict(run_dir=run_dir, lines=lines, seen=seen, after3=after3, state=state,
                state2=state2, lines2=lines2, seen2=seen2, tp=tp)


def test_run_training_steps_logs_and_validates(micro_run):
    r = micro_run
    assert [it for it, _ in r["seen"]] == [1, 2, 3]
    assert all(np.isfinite(loss) for _, loss in r["seen"])
    assert r["state"].iteration == 3
    assert sum(ln.startswith("iter ") for ln in r["lines"]) == 3
    assert [ln.split(":")[0] for ln in r["lines"] if ln.startswith("validation")] == \
        ["validation @2", "validation @3"]
    assert "scrubbed_grads=" in r["lines"][0] and "total=" in r["lines"][0]


def test_run_training_saves_latest_and_best(micro_run):
    names = sorted(os.listdir(os.path.join(micro_run["run_dir"], "checkpoints")))
    assert "latest.pt" in names
    best = [n for n in names if n.startswith("best_")]
    assert len(best) == 1 and not [n for n in names if n.endswith(".tmp")]


def test_resume_starts_at_the_saved_iteration(micro_run):
    r = micro_run
    assert r["lines2"][0].endswith("at iter 3")
    assert r["seen2"] == [4, 5] and r["state2"].iteration == 5
    # the resumed model started from the first run's weights, not its own
    moved = [float((p.detach() - r["after3"][n]).abs().max())
             for n, p in r["state2"].model.named_parameters()]
    # two Adam steps: with beta2 = 0.99 a step is at most lr / sqrt(1 - beta2) = 10 lr
    assert 0 < max(moved) <= 2 * 10 * 1e-3


def test_validation_metrics(micro_run):
    tp = micro_run["tp"]
    fn = eval_metrics_fn(tp.statics)
    val = run_validation(fn, [tp.batch, tp.batch])
    one = fn(tp.batch)
    assert set(val) == {"psnr", "ssim"} and np.isfinite(val["psnr"]) and -1 <= val["ssim"] <= 1
    assert val["psnr"] == pytest.approx(one["psnr"]) and val["ssim"] == pytest.approx(one["ssim"])
    assert run_validation(fn, []) == {"psnr": 0.0, "ssim": 0.0}
