"""The port's frames-data-parallel render (`parallel/batch_render.py`,
`cli/inference.py:render_set(dp_frames=True)`) on two gloo ranks on the CPU,
against the JAX package's `make_batch_frame_renderer` on its eight CPU
devices, as tests/test_batch_render.py holds the JAX renderer.

The JAX side builds only what it renders with: the micro configuration's
rig and renderer (a jitted init), the random avatar of
tests/test_batch_render.py and the micro batch's eight target poses. Its
refiner weights are carried into the port by `convert.py`. One world of two
ranks runs every rank-side check (`torch_ranks.batch_world`). Held: the
gathered frames against JAX to atol 2e-5, but for one frame's depth tie,
and bit-equal to the frames the same process renders one by one; and
`render_set(dp_frames=True)` over the two ranks writes the PNGs of the
sequential driver, bit for bit.

Why a share: in frame 7 two Gaussians that cover pixel (17, 18) lie one
float32 ulp apart in depth. Each package sorts by the full depth, but the
two projections round the depths otherwise, so the pair blends in the
opposite order in the two packages: 12 of the frame's 3,072 raw values
differ, by up to 4.7e-3, and the refiner spreads that over its
neighbourhood. Every other raw value is within 2e-6.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar.inferer import InfererConfig
from guava_renderer_tpu.avatar.state import GaussianAvatar, GaussianSet
from guava_renderer_tpu.bodymodel.ehm import EhmModel
from guava_renderer_tpu.bodymodel.synthetic import synthetic_ehm
from guava_renderer_tpu.core.cameras import Camera
from guava_renderer_tpu.ops.gsplat import RasterizeSettings
from guava_renderer_tpu.parallel.batch_render import make_batch_frame_renderer
from guava_renderer_tpu.parallel.batch_render import pad_to_multiple as jpad
from guava_renderer_tpu.parallel.mesh import data_parallel_mesh
from guava_renderer_tpu.train.pipeline import _unpack_params, make_models
from guava_renderer_tpu_torch.data.codec import read_rgb
from guava_renderer_tpu_torch.data.synthetic import write_synthetic_dataset
from guava_renderer_tpu_torch.parallel import mesh
from guava_renderer_tpu_torch.parallel.batch_render import pad_to_multiple
from guava_renderer_tpu_torch.testing import synthetic_batch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
RANKS = 2
FRAMES = 8
ATOL = 2e-5
TIE_SHARE = 5e-3     # share of a tied frame's raw values that may differ by more
TIE_ATOL = 1e-2
MICRO_CFG = InfererConfig(
    image_size=32, uvmap_size=16, invtanfov=3.0, dino_out_dim=4, uv_out_dim=8, smplx_fea_dim=8,
    prj_out_dim=8, global_vertex_dim=16, uv_base_dim=4, style_dim=32, num_mlp=2,
    channel_scale=16.0, vit_dim=64, vit_depth=5, vit_heads=4, pyramid_dims=(16, 16, 16, 16))


def _avatar(extras, V, rng):
    """tests/test_batch_render.py's random avatar, as numpy arrays."""
    uv_valid = np.asarray(extras.uvmap_mask).reshape(-1)
    N = uv_valid.shape[0]

    def mk(shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def quats(n):
        q = rng.normal(size=(1, n, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    return dict(
        vtx_positions=mk((1, V, 3), -0.2, 0.2), vtx_colors=mk((1, V, 32), 0, 1),
        vtx_opacity=mk((1, V, 1), 0.3, 0.9), vtx_scales=mk((1, V, 3), 0.01, 0.05),
        vtx_rotations=quats(V), uv_local_xyz=mk((1, N, 3), -0.3, 0.3),
        uv_colors=mk((1, N, 32), 0, 1), uv_opacity=mk((1, N, 1), 0.3, 0.9),
        uv_scales=mk((1, N, 3), 0.05, 0.2), uv_rotations=quats(N),
        uv_binding_face=np.asarray(extras.uvmap_f_idx).reshape(-1).astype(np.int64),
        uv_face_bary=np.asarray(extras.uvmap_f_bary).reshape(-1, 3).astype(np.float32),
        uv_valid=uv_valid)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batch_render")
    smplx, flame, extras = synthetic_ehm(uv_size=16, body_side=12, head_side=6, n_shape=8,
                                         n_exp=4, cache=False)
    ehm = EhmModel.build(smplx, flame, extras)
    # the micro configuration's raster, with the JAX default cap of 16 tiles a
    # Gaussian: the avatar's largest Gaussians reach more than its cap of 4
    _, renderer = make_models(MICRO_CFG, smplx.num_vertices, refiner_channel_scale=16.0,
                              raster_settings=RasterizeSettings(tile=16, chunk=8))
    P = 16
    gs = GaussianSet(xyz=jnp.zeros((1, P, 3)), rotation=jnp.tile(jnp.asarray([1.0, 0, 0, 0]),
                                                                  (1, P, 1)),
                     scaling=jnp.full((1, P, 3), 0.01), opacity=jnp.full((1, P, 1), 0.5),
                     colors=jnp.zeros((1, P, 32)))
    tanfov = 1.0 / MICRO_CFG.invtanfov
    cams = [Camera(R=jnp.eye(3), t=jnp.asarray([0.0, 0, 6.0]), tanfovx=jnp.asarray(tanfov),
                   tanfovy=jnp.asarray(tanfov), width=32, height=32)]
    rparams = jax.jit(lambda k: renderer.init(k, gs, cams))(jax.random.PRNGKey(0))["params"]

    avatar_np = _avatar(extras, smplx.num_vertices, np.random.default_rng(0))
    tgt = synthetic_batch(np.random.default_rng(0), FRAMES, 32, 28, smplx.n_shape,
                          smplx.n_exp)["target"]
    rend = make_batch_frame_renderer(renderer, ehm, jnp.asarray(smplx.faces), _unpack_params,
                                     image_size=32, invtanfov=MICRO_CFG.invtanfov,
                                     mesh=data_parallel_mesh(FRAMES))
    jrenders, jraws = rend(rparams, GaussianAvatar(**{k: jnp.asarray(v)
                                                      for k, v in avatar_np.items()}),
                           jax.tree_util.tree_map(jnp.asarray, tgt["params"]),
                           jnp.asarray(tgt["w2c"]))
    targets = [{"params": {k: v[i] for k, v in tgt["params"].items()}, "w2c": tgt["w2c"][i]}
               for i in range(FRAMES)]

    data = str(tmp / "ds")
    write_synthetic_dataset(data, n_videos=1, n_frames=3, image_size=48, n_shape=8, n_exp=4)
    out_dir = str(tmp / "out")
    ranks = mesh.launch(RANKS, torch_ranks.batch_world,
                        jax.tree_util.tree_map(np.asarray, rparams), avatar_np, targets, MICRO,
                        data, out_dir, device="cpu")
    return {"jax": (np.asarray(jrenders), np.asarray(jraws)), "ranks": ranks,
            "out": Path(out_dir)}


def test_frames_vs_jax(runs):
    """Every frame whose raw image is within ATOL of JAX's has its refined
    image within ATOL too; the one frame with the ulp tie differs on at most
    TIE_SHARE of its raw values, by at most TIE_ATOL."""
    jrenders, jraws = runs["jax"]
    for r in runs["ranks"]:
        assert r["renders"].shape == r["raws"].shape == jraws.shape == (FRAMES, 32, 32, 3)
        raw_diff = np.abs(r["raws"] - jraws).reshape(FRAMES, -1)
        tied = [i for i in range(FRAMES) if raw_diff[i].max() > ATOL]
        assert tied == [7], tied
        assert (raw_diff[7] > ATOL).mean() <= TIE_SHARE and raw_diff[7].max() <= TIE_ATOL
        for i in range(FRAMES):
            if i not in tied:
                np.testing.assert_allclose(r["renders"][i], jrenders[i], atol=ATOL, err_msg=i)


@pytest.mark.parametrize("what", ["renders", "raws"])
def test_frames_equal_the_sequential_frames(runs, what):
    seq = runs["ranks"][0]["seq_" + what]
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r[what], seq)


def test_render_set_over_two_ranks_writes_the_sequential_pngs(runs):
    dp, seq = runs["out"] / "dp", runs["out"] / "seq"
    names = sorted(str(p.relative_to(seq)) for p in seq.rglob("*.png"))
    assert names and names == sorted(str(p.relative_to(dp)) for p in dp.rglob("*.png"))
    for name in names:
        assert np.array_equal(read_rgb(str(dp / name)), read_rgb(str(seq / name))), name
    for f in ("avatar.ply", "vid000_compare.mp4", "speed_info.json"):
        assert (dp / "vid000" / f).exists(), f


def test_render_set_results_on_rank_0(runs):
    r0, r1 = runs["ranks"]
    assert r0["dp_results"]["vid000"]["frames"] == r0["seq_results"]["vid000"]["frames"] == 3
    assert r0["dp_results"]["vid000"]["render_fps"] > 0 and r1["dp_results"] == {}


def test_no_jax_in_a_rank(runs):
    assert all(r["jax"] is False and r["threads"] == 1 for r in runs["ranks"])


@pytest.mark.parametrize("n,multiple", [(5, 8), (8, 8), (3, 2), (1, 4)])
def test_pad_to_multiple_vs_jax(n, multiple):
    tree = {"a": np.arange(n), "b": np.ones((n, 2), np.float32) * np.arange(n)[:, None]}
    want, wn = jpad(jax.tree_util.tree_map(jnp.asarray, tree), multiple)
    for k in tree:       # the port pads a list of per-frame records
        got, gn = pad_to_multiple(list(tree[k]), multiple)
        assert gn == wn == n
        np.testing.assert_array_equal(np.stack(got), np.asarray(want[k]))
