"""The config-driven trainer's resume, its entry point and the teacher tool
(`cli/trainer_loop.py:run_training`, `cli/train.py`,
`tools/make_teacher_dataset.py`) on micro_synthetic.yaml and a micro store
the test writes. tests/test_torch_trainer_cli.py holds the trainer against
JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from guava_renderer_tpu.data.tracked import TrackedVideoDataset as JDataset
from guava_renderer_tpu_torch.cli import context as tctx
from guava_renderer_tpu_torch.cli import trainer_loop
from guava_renderer_tpu_torch.data.store import RecordStore
from guava_renderer_tpu_torch.data.synthetic import write_synthetic_dataset
from guava_renderer_tpu_torch.data.tracked import TrackedVideoDataset, build_dataset
from guava_renderer_tpu_torch.tools.make_teacher_dataset import main as teacher_main
from guava_renderer_tpu_torch.tools.make_teacher_dataset import make_teacher_dataset
from guava_renderer_tpu_torch.train.trainstep import make_train_state
from guava_renderer_tpu_torch.utils.config import load_config
from guava_renderer_tpu_torch.utils.logging_utils import TRACE_FILE

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    data = str(tmp / "ds")
    write_synthetic_dataset(data, n_videos=1, n_frames=4, image_size=48, n_shape=8, n_exp=4)
    cfg = load_config(MICRO, {"DATASET": {"data_path": data}, "TRAIN": {"check_interval": 2}})
    return tmp, cfg


def _run(cfg, run_dir, **kw):
    rt = tctx.build_runtime(cfg, synthetic_assets=True, device="cpu")
    return rt, trainer_loop.run_training(rt, build_dataset(cfg, "train"),
                                         build_dataset(cfg, "valid"), run_dir, **kw)


def test_resume_goes_on_at_the_next_iteration(micro):
    tmp, cfg = micro
    run_dir = str(tmp / "run")
    _, state = _run(cfg, run_dir, max_iters=2)
    first = {k: v.clone() for k, v in state.model.state_dict().items()}
    latest = os.path.join(run_dir, "checkpoints", "latest.pt")
    _, state2 = _run(cfg, run_dir, basemodel=latest, max_iters=3, debug=True)
    log = (Path(run_dir) / "train_log.txt").read_text()
    assert f"warm start from {latest} at iter 2" in log
    assert "iter 3:" in log and "iter 2:" not in log.split("warm start")[-1]
    assert "validation @3" in log and state2.iteration == 3
    assert any(not torch.equal(v, state2.model.state_dict()[k]) for k, v in first.items())
    # without debug the log has iteration lines only every 100 and at the end
    assert sum(line.startswith("iter ") for line in
               log.split("warm start")[0].splitlines()) == 0


def test_accumulated_remat_run_follows_the_batched_run(micro, monkeypatch):
    """TRAIN.host_accum + TRAIN.remat, as teacher512 trains, against the plain
    batched step: 4 iterations of run_training at the config's learning rate from
    the same init: every iteration's loss to rtol 1e-4 (tests/test_torch_train_e2e.py's
    LOSS_RTOL; the two sum orders part them by ~4e-7 here)."""
    tmp, cfg = micro
    real_loss_fn = trainer_loop.make_loss_fn
    losses = {}
    for accum in (False, True):
        seen = losses[accum] = []

        def recording_loss_fn(*a, seen=seen, **kw):
            fn = real_loss_fn(*a, **kw)

            def wrapped(batch, iteration):
                loss, metrics = fn(batch, iteration)
                seen.append((iteration, float(loss.detach())))
                return loss, metrics
            return wrapped

        monkeypatch.setattr(trainer_loop, "make_loss_fn", recording_loss_fn)
        _run(cfg.merge({"TRAIN": {"host_accum": accum, "remat": accum}}),
             str(tmp / f"accum_{accum}"), max_iters=4)
    batched = [v for _, v in losses[False]]
    per_sample = np.array([v for _, v in losses[True]]).reshape(4, -1)
    assert [it for it, _ in losses[False]] == [0, 1, 2, 3]
    assert per_sample.shape == (4, int(cfg.TRAIN.batch_size))
    np.testing.assert_allclose(per_sample.mean(axis=1), batched, rtol=1e-4)


def test_several_devices_raise_naming_slice_10(micro):
    """n_devices=2 outside a process group: run_training launches two gloo
    ranks itself (tests/test_torch_parallel.py runs it on ranks), and rank
    0's trained state lands in the caller's modules."""
    tmp, cfg = micro
    run_dir = str(tmp / "two")
    rt, state = _run(cfg, run_dir, max_iters=1, n_devices=2)
    assert state.iteration == 1 and state.model is not None
    saved = torch.load(os.path.join(run_dir, "checkpoints", "latest.pt"), map_location="cpu",
                       weights_only=False)["state"]["model"]
    got = rt.model.state_dict()
    assert sorted(saved) == sorted(got)
    assert all(torch.equal(v, got[k]) for k, v in saved.items())
    log = (Path(run_dir) / "train_log.txt").read_text()
    assert log.count("iter 1:") == 1 and "validation @1" in log
    assert "data-parallel over 2 ranks" in log


def test_entry_point_in_a_subprocess(micro):
    tmp, cfg = micro
    cfg_path = tmp / "micro.yaml"
    cfg._dump(str(cfg_path))
    env = dict(os.environ, GUAVA_OUTPUT_DIR=str(tmp / "out"), OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "guava_renderer_tpu_torch.cli.train", "-c", str(cfg_path),
         "--synthetic_assets", "--max_iters", "2", "--debug", "--device", "cpu"],
        cwd=str(tmp), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp / "out" / "training" / "micro"
    assert (run / "checkpoints" / "latest.pt").is_file()
    text = (run / "train_log.txt").read_text()
    assert "iter 1:" in text and "iter 2:" in text and "validation @2" in text


def test_profile_dir_traces_the_second_iteration(tmp_path):
    """`profile_dir` writes a Chrome trace of one iteration, the first after a
    warm-up (a toy model: the trace of a micro step is ~90 MB on the CPU)."""
    torch.manual_seed(0)
    state = make_train_state(torch.nn.Linear(3, 2), learning_rate=1e-2)
    x = torch.ones(4, 3)

    def loss_fn(batch, iteration):
        loss = (state.model(batch) ** 2).mean()
        return loss, {"loss": loss}

    lines = []
    trainer_loop.train_on_batches(state, loss_fn, None, [x], 3, str(tmp_path / "run"),
                                  log_every=1, log=lines.append,
                                  profile_dir=str(tmp_path / "prof"))
    assert "profiler trace of iteration 2 written to" in "\n".join(lines)
    trace = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and "addmm" in n for n in names)
    assert [ln.split(":")[0] for ln in lines if ln.startswith("iter ")] == \
        ["iter 1", "iter 2", "iter 3"]


def test_teacher_tool_at_micro(tmp_path):
    out = str(tmp_path / "teacher")
    cov = make_teacher_dataset(out, MICRO, videos=1, frames=3, seed=7, device="cpu",
                               log=lambda s: None)
    assert len(cov) == 3 and all(c > 0 for c in cov.values())
    store = RecordStore(os.path.join(out, "img_store.grv"))
    assert store.backend == "native" and len(store) == 6
    kw = dict(image_size=32, feature_img_size=28, origin_image_size=48)
    p, j = TrackedVideoDataset(out, "test", **kw), JDataset(out, "test", **kw)
    for i in range(len(j)):
        a, b = p[i], j[i]
        for part in ("source", "target"):
            for k in ("image", "w2c"):
                np.testing.assert_array_equal(a[part][k], b[part][k])
        np.testing.assert_array_equal(a["target"]["mask"], b["target"]["mask"])
    assert float(p[0]["target"]["mask"].mean()) > 0


def test_teacher_tool_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teacher_main(["--out", str(tmp_path / "t"), "-c", MICRO, "--videos", "1",
                      "--frames", "2"])


def test_restore_continues_as_the_run_would_have(tmp_path):
    """`run_training`'s warm start: a state restored from a checkpoint takes the
    same next step as the state that was saved (weights, moments and the
    schedule's position come from the file, through `CheckpointManager.restore`)."""
    def make(seed):
        torch.manual_seed(seed)
        return make_train_state(torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2)),
                                learning_rate=1e-2, lr_decay_rate=0.5, lr_decay_iter=4)

    x = torch.arange(12.0).reshape(4, 3) / 10

    def steps(state, n):
        def loss_fn(batch, iteration):
            loss = (state.model(batch) ** 2).mean()
            return loss, {"loss": loss}
        step = trainer_loop.make_train_step(loss_fn, state)
        for _ in range(n):
            step(x)

    ran = make(0)
    steps(ran, 2)
    ckpts = trainer_loop.CheckpointManager(str(tmp_path))
    path = ckpts.save_latest(ran, 2)
    restored, done = ckpts.restore(make(1), path)
    assert done == 2 and restored.iteration == 2
    assert [g["lr"] for g in restored.optimizer.param_groups] == \
        [g["lr"] for g in ran.optimizer.param_groups]
    steps(ran, 1)
    steps(restored, 1)
    for a, b in zip(ran.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)
