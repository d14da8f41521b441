"""The config-driven trainer (`cli/trainer_loop.py:run_training`) against
the JAX package, on micro_synthetic.yaml and a micro store the test writes.

The JAX runtime's `init_params` is carried into the port (a port checkpoint
passed as `basemodel`; its LPIPS through MODEL.pretrained_dir). At learning
rate 0, two iterations: the port's first loss, on the batch its loader
gave, equals the JAX loss on that batch to rtol 1e-4 (tests/
test_torch_train_e2e.py's LOSS_RTOL), and its validation PSNR/SSIM equal
the JAX `_eval_metrics_fn`'s on the validation batch to rtol 1e-4 (SSIM
also within 1e-5 absolute: it is ~2.7e-4 at these random weights, a
difference of means where float32 sums cancel, and the two packages part
by ~1e-6). The JAX side compiles one function: the forward over both
batches, the train batch's loss and the validation metrics. The run directory, log, checkpoints and image grids are checked
on the same run; tests/test_torch_trainer_entry.py covers the resume, the
entry point and the teacher tool.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.cli import context as jctx
from guava_renderer_tpu.data.loader import collate as jcollate
from guava_renderer_tpu.data.tracked import TrackedVideoDataset as JDataset
from guava_renderer_tpu.ops.ssim import psnr as jpsnr
from guava_renderer_tpu.ops.ssim import ssim as jssim
from guava_renderer_tpu.train.losses import OptimizationLoss as JOptimizationLoss
from guava_renderer_tpu.train.pipeline import forward_pipeline as jforward_pipeline
from guava_renderer_tpu.utils.config import load_config as jload_config
from guava_renderer_tpu_torch.cli import context as tctx
from guava_renderer_tpu_torch.cli import trainer_loop
from guava_renderer_tpu_torch.convert import model_from_flax, state_dict_from_flax
from guava_renderer_tpu_torch.data.codec import decode_jpeg
from guava_renderer_tpu_torch.data.synthetic import write_synthetic_dataset
from guava_renderer_tpu_torch.data.tracked import build_dataset
from guava_renderer_tpu_torch.train.checkpoints import CheckpointManager
from guava_renderer_tpu_torch.train.trainstep import make_train_state
from guava_renderer_tpu_torch.train.weights import save_converted_params
from guava_renderer_tpu_torch.utils.config import load_config

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
LOSS_RTOL = 1e-4          # tests/test_torch_train_e2e.py's
METRIC_RTOL = 1e-4
SSIM_ATOL = 1e-5          # the random weights' SSIM is ~2.7e-4: float32 sums part by ~1e-6


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.detach().cpu().numpy()


def _cat_j(a, b):
    if isinstance(a, dict):
        return {k: _cat_j(a[k], b[k]) for k in a}
    return jnp.concatenate([a, b])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    data = str(tmp / "ds")
    write_synthetic_dataset(data, n_videos=1, n_frames=4, image_size=48, n_shape=8, n_exp=4)
    over = {"DATASET": {"data_path": data}, "MODEL": {"pretrained_dir": str(tmp / "pre")},
            "TRAIN": {"visual_interval": 1, "check_interval": 2},
            "OPTIMIZE": {"learning_rate": 0.0}}

    mp = pytest.MonkeyPatch()
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        jrt = jctx.build_runtime(jload_config(MICRO, over), synthetic_assets=True)
    finally:
        mp.undo()
    with jax.default_prng_impl("unsafe_rbg"):
        params = jax.jit(lambda: jctx.init_params(jrt, seed=0))()
    params = jax.tree_util.tree_map(np.asarray, params)

    # the JAX weights as a port checkpoint (saved at another learning rate: the
    # run keeps its config's), its LPIPS as the pretrained file
    (tmp / "pre").mkdir()
    save_converted_params(str(tmp / "pre" / "lpips_alex.pt"), state_dict_from_flax(params["lpips"]))
    cfg = load_config(MICRO, over)
    rt = tctx.build_runtime(cfg, synthetic_assets=True, device="cpu")
    model_from_flax(params["model"], rt.inferer, rt.renderer)
    base = CheckpointManager(str(tmp / "base")).save_named(
        "init", make_train_state(rt.model, learning_rate=1e-3), 0)
    before = {k: v.clone() for k, v in rt.model.state_dict().items()}

    seen = {"losses": [], "batches": [], "val": []}
    real_loss_fn, real_validation = trainer_loop.make_loss_fn, trainer_loop.run_validation

    def recording_loss_fn(*a, **kw):
        fn = real_loss_fn(*a, **kw)

        def wrapped(batch, iteration):
            loss, metrics = fn(batch, iteration)
            seen["losses"].append(float(loss.detach()))
            seen["batches"].append(_np_tree(batch))
            return loss, metrics
        return wrapped

    def recording_validation(eval_fn, valid_batches):
        val = real_validation(eval_fn, valid_batches)
        seen["val"].append(val)
        return val

    mp = pytest.MonkeyPatch()
    mp.setattr(trainer_loop, "make_loss_fn", recording_loss_fn)
    mp.setattr(trainer_loop, "run_validation", recording_validation)
    run_dir = str(tmp / "run")
    try:
        state = trainer_loop.run_training(
            rt, build_dataset(cfg, "train"), build_dataset(cfg, "valid"), run_dir,
            basemodel=base, debug=True, max_iters=2)
    finally:
        mp.undo()

    # JAX: one compiled function, the forward over the first train batch and the
    # validation batch, then the train batch's loss and the validation metrics
    vds = JDataset(data, "valid", image_size=32, feature_img_size=28, origin_image_size=48,
                   head_crop_size=24, hand_crop_size=24)
    vbatch = jcollate([vds[0], vds[1]])
    tb = seen["batches"][0]
    lp = jrt.statics.lpips

    def jloss_and_metrics(p, b, vb):
        outputs, avatar = jforward_pipeline(p["model"], _cat_j(b, vb), jrt.statics)[:2]
        opt_loss = JOptimizationLoss(jrt.statics.loss_cfg,
                                     lambda x, y: lp.apply({"params": p["lpips"]}, x, y))
        tgt = b["target"]
        loss, _ = opt_loss(outputs.renders[:2], outputs.raw_renders[:2], tgt["image"],
                           tgt["mask"], tgt["boxes"], avatar.uv_local_xyz[:2],
                           avatar.uv_scales[:2], 0)
        r = jnp.clip(outputs.renders[2:], 0, 1)
        gt = vb["target"]["image"] * vb["target"]["mask"]
        return loss, jpsnr(r, gt).mean(), jssim(r, gt)

    jloss, jpsnr_v, jssim_v = jax.jit(jloss_and_metrics)(params, tb, vbatch)
    jval = {"psnr": float(jpsnr_v), "ssim": float(jssim_v)}
    return dict(tmp=tmp, data=data, cfg=cfg, run_dir=run_dir, state=state, seen=seen,
                jloss=float(jloss), jval=jval, before=before, rt=rt,
                log=(Path(run_dir) / "train_log.txt").read_text())


def test_first_loss_equals_jax_on_the_loader_batch(runs):
    seen = runs["seen"]
    assert len(seen["losses"]) == 2 and all(np.isfinite(seen["losses"]))
    np.testing.assert_allclose(seen["losses"][0], runs["jloss"], rtol=LOSS_RTOL)


def test_learning_rate_is_the_configs_after_a_warm_start(runs):
    """The checkpoint was saved at lr 1e-3; the run's config says 0, and the
    weights did not move."""
    assert [g["lr"] for g in runs["state"].optimizer.param_groups] == [0.0, 0.0]
    after = runs["rt"].model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in runs["before"].items())


def test_loader_batches_equal_the_jax_dataset(runs):
    """The trainer's first batch is the JAX dataset's records, collated in the
    loader's epoch-0 order (seed 0, the dataset's own source draws)."""
    cfg = runs["cfg"]
    ds = JDataset(runs["data"], "train", image_size=32, feature_img_size=28,
                  origin_image_size=48, head_crop_size=24, hand_crop_size=24)
    idx = np.arange(len(ds))
    np.random.default_rng(0).shuffle(idx)
    want = jcollate([ds[int(i)] for i in idx[:int(cfg.TRAIN.batch_size)]])
    got = runs["seen"]["batches"][0]

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)
    walk(got, want)


def test_validation_equals_jax_eval_metrics(runs):
    val = runs["seen"]["val"][0]
    np.testing.assert_allclose(val["psnr"], runs["jval"]["psnr"], rtol=METRIC_RTOL)
    np.testing.assert_allclose(val["ssim"], runs["jval"]["ssim"], rtol=METRIC_RTOL,
                               atol=SSIM_ATOL)


def test_run_dir_log_checkpoints_and_grid(runs):
    run = Path(runs["run_dir"])
    assert (run / "config.yaml").is_file() and (run / "git_rev.txt").is_file()
    assert load_config(str(run / "config.yaml")).to_dict() == runs["cfg"].to_dict()
    for rel in ("codes/guava_renderer_tpu_torch/cli/trainer_loop.py",
                "codes/configs/train/micro_synthetic.yaml", "codes/chip_smoke.py",
                "codes/bench_torch.py"):
        assert (run / rel).is_file(), rel
    log = runs["log"]
    assert "warm start from" in log and "at iter 0" in log
    assert "iter 1:" in log and "iter 2:" in log and "it/s" in log and "batch wait" in log
    assert "validation @2: psnr=" in log
    ckpts = sorted(os.listdir(run / "checkpoints"))
    assert "latest.pt" in ckpts and any(c.startswith("best_2_") for c in ckpts)
    _, it = CheckpointManager(str(run)).restore(make_train_state(runs["rt"].model))
    assert it == 2
    grids = sorted(os.listdir(run / "visuals_training" / "train_render"))
    assert grids == ["training_1.jpg", "training_2.jpg"]
    grid = decode_jpeg((run / "visuals_training" / "train_render" / "training_1.jpg").read_bytes())
    assert grid.shape == (3 * 32, 2 * 32, 3)       # GT / refined / raw rows, two items
