"""The port's multi-device training (`train/trainstep.py`: the parallel,
accumulation and eval steps; `cli/trainer_loop.py:run_training` over ranks;
`cli/train.py --devices`) on gloo ranks on the CPU, against the JAX
package's steps on its eight CPU devices.

One world of two ranks runs every rank-side check of the file
(`torch_ranks.parallel_world`). Held:
- on the toy losses of tests/test_trainstep.py, the data-parallel step,
  the JAX step's per-sample form (`sample_scan=True`) against the port's
  accumulation step over `split_samples` of the rank's slice, the
  accumulation step over four microbatches and the eval step against the
  JAX functions, parameters and loss to rtol 1e-5 and atol 1e-6;
- the NaN scrub after the mean, as the JAX optimizer runs it: a NaN
  gradient on one rank zeroes that entry on every rank (scrubbing before
  the mean would move it);
- on the micro pipeline, the data-parallel step against the one-process
  step on the whole batch (the port's one-process step is held against JAX
  by tests/test_torch_train_e2e.py; a JAX micro pipeline costs minutes on
  the CPU), and two accumulated copies of a microbatch against the
  data-parallel step, to rtol 1e-5 and atol 1e-6 as `__graft_entry__.py`
  holds the JAX pair;
- bit-equal parameters on both ranks after every step, and no JAX in a rank;
- `cli.train --devices 2 --device cpu` launching two CPU ranks (the launch
  replaced by a recorder: the ranks' training is the world's), and `-d` on
  the card read as `main/train.py` reads it (a lone number under 8 is that
  one card).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from guava_renderer_tpu.train.trainstep import (
    TrainState, make_accum_train_step, make_optimizer, make_parallel_eval_step,
    make_parallel_train_step)
from guava_renderer_tpu_torch.cli import train as cli_train
from guava_renderer_tpu_torch.data.synthetic import write_synthetic_dataset
from guava_renderer_tpu_torch.parallel import mesh
from guava_renderer_tpu_torch.train.trainstep import lr_labels

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_main_train", ROOT / "main" / "train.py")
jtrain_main = importlib.util.module_from_spec(_spec)       # main/train.py, for parse_devices
_spec.loader.exec_module(jtrain_main)

MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
RANKS = 2
LR = 1e-2
MICRO_LR = 1e-3
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-7


def toy_params():
    return {
        "dense": {"kernel": np.ones((4, 4), np.float32), "bias": np.zeros(4, np.float32)},
        "refiner": {"generator": {"style_mlp": {"mlp0": {
            "kernel": np.ones((4, 4), np.float32)}}}},
        "final_linear": {"kernel": np.ones((4, 4), np.float32)},
    }


def toy_batch(n=8):
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(n, 4)).astype(np.float32),
            "y": rng.normal(size=(n, 4)).astype(np.float32)}


def nan_batch(n=8):
    b = toy_batch(n)
    b["s"] = np.ones(n, np.float32)
    b["s"][0] = 0.0          # sample 0: on rank 0 here, on device 0 in JAX
    return b


def jtoy_loss(params, batch, iteration):
    x, y = batch["x"], batch["y"]
    pred = x @ params["dense"]["kernel"] + params["dense"]["bias"]
    pred = pred @ params["refiner"]["generator"]["style_mlp"]["mlp0"]["kernel"]
    pred = pred @ params["final_linear"]["kernel"]
    loss = jnp.mean((pred - y) ** 2)
    return loss, {"loss": loss}


def jnan_loss(params, batch, iteration):
    loss, _ = jtoy_loss(params, batch, iteration)
    loss = loss + jnp.mean(jnp.sqrt(batch["s"] + 0.0 * params["dense"]["bias"][0]))
    return loss, {"loss": loss}


def jtoy_metrics(params, b):
    pred = b["x"] @ params["dense"]["kernel"] + params["dense"]["bias"]
    return {"mse": jnp.mean((pred - b["y"]) ** 2), "mean_x": jnp.mean(b["x"])}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jstate(params, opt):
    p = jax.tree_util.tree_map(jnp.asarray, params)
    return TrainState(p, opt.init(p), jnp.asarray(0))


@pytest.fixture(scope="module")
def jref():
    """The JAX steps on the toy losses: the DP steps on 8 devices, the
    accumulation step on 2 (4 microbatches of one sample a device)."""
    opt = make_optimizer(toy_params(), learning_rate=LR)
    mesh8 = data_parallel_mesh(8)
    out = {}
    batch = jax.tree_util.tree_map(jnp.asarray, toy_batch())
    s, loss, m = make_parallel_train_step(jtoy_loss, opt, mesh8)(
        _jstate(toy_params(), opt), shard_batch(batch, mesh8))
    out["dp"] = (_flat(s.params), float(loss), float(m["loss"]))
    s, loss, _ = make_parallel_train_step(jtoy_loss, opt, mesh8, sample_scan=True)(
        _jstate(toy_params(), opt), shard_batch(batch, mesh8))
    out["dp_scan"] = (_flat(s.params), float(loss))
    mesh2 = data_parallel_mesh(2)
    micro = [shard_batch(jax.tree_util.tree_map(lambda x, i=i: x[2 * i:2 * i + 2], batch), mesh2)
             for i in range(4)]
    s, loss, m = make_accum_train_step(jtoy_loss, opt, mesh2)(_jstate(toy_params(), opt), micro)
    out["accum"] = (_flat(s.params), float(loss), float(m["loss"]), int(s.iteration))
    ev = make_parallel_eval_step(jtoy_metrics, mesh8)(
        jax.tree_util.tree_map(jnp.asarray, toy_params()), shard_batch(batch, mesh8))
    out["eval"] = {k: float(v) for k, v in ev.items()}
    nb = jax.tree_util.tree_map(jnp.asarray, nan_batch())
    s, loss, _ = make_parallel_train_step(jnan_loss, opt, mesh8)(
        _jstate(toy_params(), opt), shard_batch(nb, mesh8))
    out["nan"] = (_flat(s.params), float(loss))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    data = str(tmp / "ds")
    write_synthetic_dataset(data, n_videos=1, n_frames=4, image_size=48, n_shape=8, n_exp=4)
    run_dir = str(tmp / "run")
    ranks = mesh.launch(RANKS, torch_ranks.parallel_world,
                        (toy_params(), toy_batch(), nan_batch(), LR), MICRO_LR,
                        (MICRO, data, run_dir), device="cpu")
    return {"ranks": ranks, "run_dir": run_dir, "data": data, "tmp": tmp}


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind", ["dp", "dp_scan"])
def test_parallel_step_vs_jax(world, jref, kind):
    got, (want, loss) = world["ranks"][0][kind], jref[kind][:2]
    _close(got["params"], want)
    np.testing.assert_allclose(got["loss"], loss, rtol=RTOL)


def test_parallel_step_metrics_vs_jax(world, jref):
    np.testing.assert_allclose(world["ranks"][0]["dp"]["metric"], jref["dp"][2], rtol=RTOL)


def test_accum_step_vs_jax(world, jref):
    got = world["ranks"][0]["accum"]
    want, loss, metric, iteration = jref["accum"]
    _close(got["params"], want)
    np.testing.assert_allclose([got["loss"], got["metric"]], [loss, metric], rtol=RTOL)
    assert got["iteration"] == iteration == 1


def test_eval_step_vs_jax(world, jref):
    for r in world["ranks"]:
        _close(r["eval"], jref["eval"])


def test_nan_on_one_rank_is_zeroed_on_every_rank(world, jref):
    """bias[0]'s gradient is NaN on rank 0 alone. Averaged first, it is NaN
    everywhere and scrubbed to 0, so bias[0] stays where it was, as in JAX;
    scrubbed per rank first, rank 1's finite half would move it."""
    want, loss = jref["nan"]
    assert want["dense.bias"][0] == 0.0
    for r in world["ranks"]:
        got = r["nan"]
        assert got["grads"]["dense.bias"][0] == 0.0
        assert got["params"]["dense.bias"][0] == 0.0
        assert got["scrubbed"] == 1
        _close(got["params"], want)
        np.testing.assert_allclose(got["loss"], loss, rtol=RTOL)


@pytest.mark.parametrize("kind", ["dp", "dp_scan", "accum", "nan"])
def test_ranks_hold_bit_equal_toy_parameters(world, kind):
    a, b = (r[kind]["params"] for r in world["ranks"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_slow_group_is_the_jax_group():
    model = torch_ranks.module_from_tree(toy_params())
    assert lr_labels(model) == {"dense.kernel": "normal", "dense.bias": "normal",
                                "refiner.generator.style_mlp.mlp0.kernel": "slow",
                                "final_linear.kernel": "slow"}


def test_micro_parallel_step_vs_one_process(world):
    """The loss and metrics against the one-process step on the whole batch;
    the gradient against the mean of each rank's slice's gradient taken in
    one process. (The whole batch's gradient differs from that mean by up to
    ~1.5% of a leaf's largest entry at these widths: renders that differ
    by rounding, 2e-7, flip which Gaussians a pixel takes.)"""
    micro = world["ranks"][0]["micro"]
    dp, single = micro["dp"], micro["single"]
    np.testing.assert_allclose(dp["loss"], single["loss"], rtol=RTOL)
    _close(dp["metrics"], single["metrics"], atol=1e-7)
    want_all = micro["shard_mean_grads"]
    names = [n for n, g in want_all.items() if g is not None]
    assert names and sorted(names) == sorted(n for n, g in dp["grads"].items() if g is not None)
    for n in names:
        want = want_all[n]
        np.testing.assert_allclose(dp["grads"][n], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * max(np.abs(want).max(), 1e-30),
                                   err_msg=n)


def test_micro_two_accumulated_microbatches_equal_the_parallel_step(world):
    for r in world["ranks"]:
        micro = r["micro"]
        np.testing.assert_allclose(micro["accum_same_twice"]["loss"], micro["dp"]["loss"],
                                   rtol=RTOL)
        _close(micro["accum_same_twice"]["params"], micro["dp"]["params"])


def test_micro_eval_step_vs_one_process(world):
    want = world["ranks"][0]["micro"]["single_eval"]
    for r in world["ranks"]:
        _close(r["micro"]["eval"], want)


@pytest.mark.parametrize("kind", ["dp", "accum_same_twice"])
def test_ranks_hold_bit_equal_micro_parameters(world, kind):
    a, b = (r["micro"][kind]["params"] for r in world["ranks"])
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_run_training_over_two_ranks(world):
    a, b = (r["train"] for r in world["ranks"])
    assert a["iteration"] == b["iteration"] == 1
    assert all(np.array_equal(a["params"][k], b["params"][k]) for k in a["params"])
    ckpts = Path(world["run_dir"]) / "checkpoints"
    assert (ckpts / "latest.pt").exists()
    saved = torch.load(ckpts / "latest.pt", map_location="cpu", weights_only=False)
    assert saved["iteration"] == 1
    for k, v in saved["state"]["model"].items():
        if k in a["params"]:
            assert np.array_equal(v.numpy(), a["params"][k]), k


def test_run_training_logs_once(world):
    logs = list(Path(world["run_dir"]).glob("train_log.txt"))
    assert len(logs) == 1
    text = logs[0].read_text()
    assert text.count("iter 1:") == 1 and text.count("validation @1") == 1
    assert "data-parallel over 2 ranks (gloo, rank 0 on cpu)" in text


def test_no_jax_in_a_rank(world):
    for r in world["ranks"]:
        assert r["jax"] is False and r["threads"] == 1


def test_cli_train_devices_launch_gloo_ranks_on_the_cpu(monkeypatch):
    """`python -m guava_renderer_tpu_torch.cli.train --devices 2 --device cpu`
    launches two CPU ranks, each running the training entry inside its group
    (the ranks' run_training is the one the world above runs)."""
    seen = []
    monkeypatch.setattr(mesh, "launch", lambda n, fn, *args, device, devices: seen.append(
        (n, fn, args, device, devices)) or [{"model": {}}])
    out = cli_train.main(["-c", MICRO, "--synthetic_assets", "--devices", "2",
                          "--device", "cpu", "--max_iters", "1"])
    assert out == {"model": {}}
    (n, fn, args, device, devices), = seen
    assert (n, fn, device) == (2, cli_train._train_rank, "cpu")
    assert devices == [torch.device("cpu")] * 2
    assert args == (MICRO, None, False, True, 1, None)


@pytest.mark.parametrize("spec", ["0", "3", "7", "8", "16", "0,1", "0,1,2,3", "1,"])
def test_devices_parse_as_main_train(spec):
    """On the card -d gives as many devices as `main/train.py:parse_devices`
    counts: a lone number under 8 is one (a device index), a list its
    length, a larger number that many."""
    assert len(cli_train.parse_devices(spec, "cuda")) == jtrain_main.parse_devices(spec)


@pytest.mark.parametrize("spec,want", [("3", [3]), ("0", [0]), ("2,3", [2, 3]), ("1,", [1]),
                                       ("8", list(range(8)))])
def test_devices_on_the_card(spec, want):
    """A lone number under 8 is that card alone, as the reference's device
    index; a list names its cards."""
    assert cli_train.parse_devices(spec, "cuda") == [torch.device("cuda", i) for i in want]


@pytest.mark.parametrize("spec,n", [("2", 2), ("7", 7), ("auto", 1), ("", 1)])
def test_devices_count(spec, n):
    """On the CPU, which has no device indices, a lone number is the count of
    gloo ranks (the JAX `--host_devices`); 'auto' is one."""
    assert cli_train.parse_devices(spec, "cpu") == [torch.device("cpu")] * n
