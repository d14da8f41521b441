"""The port's row-band render (`parallel/sharded_render.py`) against the JAX
package's `rasterize_row_sharded` on its eight CPU devices and against the
port's own full-frame render.

The scene is the one `__graft_entry__.py` renders in bands (48 Gaussians,
64 wide), 128 rows high: eight bands of one 16-row tile row each. The band
function runs in this process, band after band; the collective wrapper runs
on two gloo ranks (two bands of 64 rows). Held to atol 2e-5, as the JAX dry
run holds its bands. Under `bf16_rows` the port's bands blend with K6, as
its full frame does, and are held to it at BF16_ATOL: K6 packs the 2D means
as bf16 hi + lo pairs (16 significant bits), and a band's shifted means
round otherwise than the full frame's (3.0e-3 apart here, where the bf16
frame lies 3.0e-3 from the float32 one). The JAX function drops the setting
(`guava_renderer_tpu/parallel/sharded_render.py:103`) and renders float32.
The JAX renders are jitted (eager shard_map interprets the blend op by op,
~70 s a call).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.core.cameras import Camera as JCamera
from guava_renderer_tpu.ops.gsplat import RasterizeSettings as JSettings
from guava_renderer_tpu.ops.gsplat import rasterize as jrasterize
from guava_renderer_tpu.parallel.mesh import data_parallel_mesh
from guava_renderer_tpu.parallel.sharded_render import rasterize_row_sharded as jsharded
from guava_renderer_tpu_torch.ops.gsplat import RasterizeSettings, rasterize
from guava_renderer_tpu_torch.parallel import mesh
from guava_renderer_tpu_torch.parallel.sharded_render import render_band

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

BANDS = 8
RANKS = 2
ATOL = 2e-5
BF16_ATOL = 4e-3
BF16_MOVES = 1e-4        # the bf16 render differs from the f32 one by more than this


def _scene():
    rng = np.random.default_rng(9)
    P = 48
    means = np.zeros((P, 3), np.float32)
    means[:, 0] = rng.uniform(-0.5, 0.5, P)
    means[:, 1] = rng.uniform(-1.0, 1.0, P)
    means[:, 2] = rng.uniform(2.5, 3.5, P)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return {"means": means,
            "colors": rng.uniform(0, 1, (P, 32)).astype(np.float32),
            "opac": rng.uniform(0.2, 0.9, (P, 1)).astype(np.float32),
            "scales": rng.uniform(0.02, 0.08, (P, 3)).astype(np.float32),
            "quats": quats, "bg": np.linspace(0, 1, 32).astype(np.float32),
            "tanfov": np.float32(0.5), "width": 64, "height": 128}


SCENE = _scene()


def _port(settings, n=BANDS):
    args, cam = torch_ranks.scene_tensors(SCENE)
    bg = torch.tensor(SCENE["bg"])
    bands = [render_band(d, n, *args, cam, bg, settings) for d in range(n)]
    full = rasterize(*args, cam, bg, settings)
    return ([np.concatenate([b[i].numpy() for b in bands], axis=1) for i in (0, 2)],
            bands[0][1].numpy(), [t.detach().numpy() for t in full])


@pytest.fixture(scope="module")
def runs():
    cam = JCamera(R=jnp.eye(3), t=jnp.zeros(3), tanfovx=jnp.asarray(SCENE["tanfov"]),
                  tanfovy=jnp.asarray(SCENE["tanfov"]), width=SCENE["width"],
                  height=SCENE["height"])
    jargs = [jnp.asarray(SCENE[k]) for k in ("means", "colors", "opac", "scales", "quats")]
    jbg = jnp.asarray(SCENE["bg"])
    st = JSettings(chunk=8, max_tiles_per_gaussian=8)
    mesh8 = data_parallel_mesh(BANDS)

    def run(fn):
        return [np.asarray(t) for t in jax.jit(fn)(*jargs)]

    jax_out = {
        "sharded": run(lambda *a: jsharded(*a, cam, jbg, mesh8, st)),
        "sharded_bf16": run(lambda *a: jsharded(*a, cam, jbg, mesh8,
                                                st._replace(bf16_rows=True))),
        "full": run(lambda *a: jrasterize(*a, cam, jbg, st)),
    }
    port = {"f32": _port(RasterizeSettings(tile=16)),
            "bf16": _port(RasterizeSettings(tile=16, bf16_rows=True)),
            "two": _port(RasterizeSettings(tile=16), n=RANKS),
            "two_bf16": _port(RasterizeSettings(tile=16, bf16_rows=True), n=RANKS)}
    ranks = mesh.launch(RANKS, torch_ranks.sharded_world, SCENE, True, device="cpu")
    return {"jax": jax_out, "port": port, "ranks": ranks}


@pytest.mark.parametrize("what", [0, 1], ids=["color", "invdepth"])
def test_bands_vs_jax_sharded(runs, what):
    got = runs["port"]["f32"][0][what]
    want = runs["jax"]["sharded"][2 * what]
    assert got.shape == want.shape == ((32,) if what == 0 else (1,)) + (128, 64)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_radii_vs_jax(runs):
    np.testing.assert_array_equal(runs["port"]["f32"][1], runs["jax"]["sharded"][1])


@pytest.mark.parametrize("kind", ["f32", "bf16", "two", "two_bf16"])
@pytest.mark.parametrize("what", [0, 1], ids=["color", "invdepth"])
def test_bands_vs_the_ports_full_frame(runs, kind, what):
    bands, _, full = runs["port"][kind]
    np.testing.assert_allclose(bands[what], full[2 * what],
                               atol=BF16_ATOL if "bf16" in kind else ATOL)


def test_jax_full_frame_is_its_bands(runs):
    """The reference agrees with itself here (it truncates nothing)."""
    for i in (0, 2):
        np.testing.assert_allclose(runs["jax"]["sharded"][i], runs["jax"]["full"][i], atol=ATOL)


def test_bf16_rows_are_honoured(runs):
    """The port's bands under bf16_rows are its bf16 frame, not its f32
    frame; the JAX bands ignore the setting."""
    f32, bf16 = runs["port"]["f32"][0][0], runs["port"]["bf16"][0][0]
    assert np.abs(bf16 - f32).max() > BF16_MOVES
    np.testing.assert_array_equal(runs["jax"]["sharded_bf16"][0], runs["jax"]["sharded"][0])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_row_sharded_over_two_ranks(runs, kind):
    """rasterize_row_sharded on two gloo ranks: every rank holds the whole
    frame, the two bands of this process's render_band gathered."""
    bands, radii, _ = runs["port"]["two" if kind == "f32" else "two_bf16"]
    for r in runs["ranks"]:
        color, rr, invd = r[kind]
        np.testing.assert_allclose(color, bands[0], atol=1e-6)
        np.testing.assert_allclose(invd, bands[1], atol=1e-6)
        np.testing.assert_array_equal(rr, radii)
    np.testing.assert_array_equal(runs["ranks"][0][kind][0], runs["ranks"][1][kind][0])


def test_no_jax_in_a_rank(runs):
    assert all(r["jax"] is False and r["threads"] == 1 for r in runs["ranks"])


def test_bands_must_be_whole_tiles():
    args, cam = torch_ranks.scene_tensors(SCENE)
    with pytest.raises(AssertionError, match="tile-aligned bands"):
        render_band(0, 3, *args, cam, torch.tensor(SCENE["bg"]), RasterizeSettings(tile=16))
