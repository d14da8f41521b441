"""Port vs JAX: the size-classed blend with a resident table (K7's and K9's
plain versions), the settings both packages refuse, and the slice as a
whole: a FramePipeline frame under size_classes + vmem_classes against the
JAX frame.

The JAX side runs Pallas in interpret mode (chunk 8) on zero-truncation
ladders (every cap is the whole tile grid). Its size-class path sorts on the
top bits of the depth and breaks ties by duplication order, the port by id,
so the small scenes' depths are spaced (`spaced_scene`). Ranking, remapped
ids and the row gather (both K9 entries: int32 ids, and the ranking's
int64 keys that the frame passes) are compared exactly, the gather also on
its edge cases; images to atol 1e-4. The
resident path's gradient is held bit for bit against the port's default
path, whose gradient tests/test_torch_gsplat_grad.py holds against JAX.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu.ops.gsplat_project import project_gaussians as jproject
from guava_renderer_tpu_torch.cli.inference import FramePipeline
from guava_renderer_tpu_torch.convert import refiner_state_dict_from_flax
from guava_renderer_tpu_torch.kernels import blend as tk
from guava_renderer_tpu_torch.kernels import gather_rows as tk9
from guava_renderer_tpu_torch.ops import gsplat as tgs
from guava_renderer_tpu_torch.ops.gsplat_project import project_gaussians as tproject

from test_torch_blend_bf16 import ATOL, NAMES, spaced_scene
from test_torch_frame import ATOL as FRAME_ATOL
from test_torch_frame import REFINER, SCENE, JRefiner, TRefiner, _jax_frames, _targets, jbench, tbench
from test_torch_frame import TILE as FRAME_TILE
from test_torch_gsplat import C, _j, _t, jax_settings, make_cams

torch.set_num_threads(2)
SIZE, TILE = 64, 16
GRID = (SIZE // TILE) ** 2
LADDER = ((8, GRID), (24, GRID), (16, GRID))     # caps = the whole grid: no truncation
L = 32                                           # the first two classes


def port_settings(**kw):
    return tgs.RasterizeSettings(**(dict(tile=TILE, size_classes=LADDER, vmem_classes=2) | kw))


def test_resident_count():
    st = port_settings()
    assert tgs.resident_count(st, 64) == L
    assert tgs.resident_count(st, 20) == 20
    assert tgs.resident_count(st._replace(vmem_classes=5), 100) == 48
    assert tgs.resident_count(st._replace(vmem_classes=0), 100) == 0


def test_ranking_and_remap_equal_jax():
    """lids, ranges, the remapped order and the original order against the
    JAX binning with the original ids as payload (tile cull off: it drops
    instances that the port keeps and the blend skips)."""
    arrs = spaced_scene(11, P=64)
    P = 64
    jc, tc = make_cams(SIZE)
    st = jax_settings(SIZE, TILE)._replace(chunk=8, size_classes=LADDER, vmem_classes=2,
                                           tile_cull=False)

    @jax.jit
    def jbin(m, s, q, o):
        jp = jproject(m, s, q, o, jc)
        contributing = jp.valid & (jp.alpha >= jgs.ALPHA_MIN)
        return jgs.bin_gaussians(jp.mean2d, jp.depth, jp.radius_bin, contributing, SIZE, SIZE,
                                 st, conic=jp.conic, alpha=jp.alpha,
                                 payload=(jnp.arange(P, dtype=jnp.int32),))

    means, _, opac, scales, quats = arrs
    j_ranges, j_order, (j_orig,), j_lids, n_valid, n_trunc = jbin(*_j((means, scales, quats,
                                                                       opac)))
    assert int(n_trunc) == 0
    n = int(n_valid)

    proj = tproject(*_t((means, scales, quats, opac)), tc)
    ranges, order = tgs.bin_gaussians(proj, SIZE, SIZE, TILE)
    lids = tgs.resident_ids(proj, SIZE, SIZE, TILE, tgs.resident_count(port_settings(), P))
    np.testing.assert_array_equal(lids.numpy(), np.asarray(j_lids))
    # the frame's route: the ranking's keys into K9, which decodes the same ids
    rows = torch.as_tensor(np.random.default_rng(3).normal(size=(P, tk.ROW)).astype(np.float32))
    ltable, klids = tk9.gather_resident(rows, *tgs.resident_keys(proj, SIZE, SIZE, TILE, L))
    np.testing.assert_array_equal(klids.numpy(), np.asarray(j_lids))
    assert torch.equal(ltable, rows[klids.long()])
    np.testing.assert_array_equal(ranges.numpy(), np.asarray(j_ranges))
    assert order.shape[0] == n
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_orig)[:n])
    remapped = tgs.remap_resident(order, lids, P)
    np.testing.assert_array_equal(remapped.numpy(), np.asarray(j_order)[:n])
    assert (remapped >= P).any() and (remapped < P).any()


def test_gather_rows_plain_vs_jax():
    rng = np.random.default_rng(9)
    P, n = 50, 37
    rows = rng.normal(size=(P, tk.ROW)).astype(np.float32)
    ids = rng.integers(0, P, n).astype(np.int32)
    table = np.zeros((P, 128), np.float32)
    table[:, :tk.ROW] = rows
    want = np.asarray(jax.jit(jgs.gather_rows)(jnp.asarray(table), jnp.asarray(ids)))
    got = tk9.gather_rows(torch.tensor(rows), torch.tensor(ids))
    np.testing.assert_array_equal(got.numpy(), want[:, :tk.ROW])
    assert tk9.gather_rows_plain(torch.tensor(rows), torch.tensor(ids)).shape == (n, tk.ROW)


# K9's edge cases: (P, ids); the JAX gather_rows takes every case but L = 0
K9_CASES = {"L=0": (50, []), "L=1": (50, [49]), "repeated ids": (50, [7, 7, 3, 7, 3, 3]),
            "ids 0 and P-1": (50, [0, 49, 0, 49, 49, 0]),
            "L=16384": (20000, np.random.default_rng(16).integers(0, 20000, 16384))}


@pytest.mark.parametrize("case", K9_CASES)
def test_gather_rows_edge_cases(case):
    """Both K9 entries on the CPU equal index_select and, where it takes the
    case, the JAX gather_rows in interpret mode (its first L rows, first 44
    columns); the launch counter does not move."""
    P, ids = K9_CASES[case]
    rng = np.random.default_rng(10)
    rows = rng.normal(size=(P, tk.ROW)).astype(np.float32)
    ids = np.asarray(ids, np.int32)
    trows, tids = torch.tensor(rows), torch.tensor(ids)
    before = tk9.launches
    want = trows.index_select(0, tids.long())
    got = tk9.gather_rows(trows, tids)
    id_bits = max(1, (P - 1).bit_length())
    keys = (torch.arange(ids.shape[0], dtype=torch.int64) << id_bits) | tids.long()
    table, lids = tk9.gather_resident(trows, keys, id_bits)
    assert got.shape == (ids.shape[0], tk.ROW) and torch.equal(got, want)
    assert torch.equal(table, want) and torch.equal(lids, tids)
    assert tk9.launches == before
    if ids.shape[0]:
        jtable = np.zeros((P, 128), np.float32)
        jtable[:, :tk.ROW] = rows
        jwant = np.asarray(jax.jit(jgs.gather_rows)(jnp.asarray(jtable), jnp.asarray(ids)))
        np.testing.assert_array_equal(got.numpy(), jwant[:ids.shape[0], :tk.ROW])


def test_gather_resident_is_the_ranking_and_gather_rows():
    """K9's frame entry on the ranking's keys gives resident_ids and their
    rows, as gather_rows_plain gathers them."""
    arrs = spaced_scene(4, P=40)
    _, tc = make_cams(SIZE)
    proj = tproject(*_t((arrs[0], arrs[3], arrs[4], arrs[2])), tc)
    rows = torch.as_tensor(np.random.default_rng(5).normal(size=(40, tk.ROW)).astype(np.float32))
    keys, id_bits = tgs.resident_keys(proj, SIZE, SIZE, TILE, 12)
    assert keys.dtype == torch.int64 and keys.shape == (12,) and id_bits == 6
    table, lids = tk9.gather_resident(rows, keys, id_bits)
    want_ids = tgs.resident_ids(proj, SIZE, SIZE, TILE, 12)
    assert torch.equal(lids, want_ids)
    assert torch.equal(table, tk9.gather_rows_plain(rows, want_ids))
    assert torch.equal(tk9.decode_ids(keys, id_bits), want_ids)


def test_gather_entries_check_their_arguments():
    rows = torch.zeros((8, tk.ROW))
    with pytest.raises(ValueError, match="keys must be"):
        tk9.gather_resident(rows, torch.zeros(3, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="id_bits"):
        tk9.gather_resident(rows, torch.zeros(3, dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="ids must be"):
        tk9.gather_rows(rows, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="rows must be"):
        tk9.gather_rows(torch.zeros((8, 43)), torch.zeros(3, dtype=torch.int32))


@pytest.fixture(scope="module")
def renders():
    """(port resident, port default, JAX vmem_classes) renders of one scene,
    with the port's gradients under both settings."""
    arrs = spaced_scene(11, P=64)
    jc, tc = make_cams(SIZE)
    bg = np.linspace(0.0, 1.0, C).astype(np.float32)
    st = jax_settings(SIZE, TILE)._replace(chunk=8, size_classes=LADDER, vmem_classes=2)
    want = jax.jit(lambda *a: jgs.rasterize(*a, jc, jnp.asarray(bg), st))(*_j(arrs))
    out = {"jax": [np.asarray(w) for w in want]}
    for name, settings in (("resident", port_settings()),
                           ("default", tgs.RasterizeSettings(tile=TILE))):
        args = [torch.tensor(a, requires_grad=True) for a in arrs]
        color, radii, invd = tgs.rasterize(*args, tc, torch.tensor(bg), settings)
        (color.square().sum() + invd.sum()).backward()
        out[name] = [color.detach(), radii, invd.detach()]
        out[name + "_grads"] = [a.grad for a in args]
    return out


def test_rasterize_resident_vs_jax(renders):
    for g, w in zip(renders["resident"], renders["jax"]):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


def test_rasterize_resident_equals_default_path(renders):
    for g, w in zip(renders["resident"], renders["default"]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_resident_gradient_equals_default_path(renders, i):
    got, want = renders["resident_grads"][i], renders["default_grads"][i]
    assert want.abs().max() > 0
    assert torch.equal(got, want)


def test_size_classes_alone_is_the_default_path():
    arrs = spaced_scene(3, P=48)
    _, tc = make_cams(SIZE)
    bg = torch.linspace(0, 1, C)
    a = tgs.rasterize(*_t(arrs), tc, bg, port_settings(vmem_classes=0))
    b = tgs.rasterize(*_t(arrs), tc, bg, tgs.RasterizeSettings(tile=TILE))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_resident_blend_kernel_contract():
    """K7's plain version on (rows, rows[lids], remapped order) is K1's on
    (rows, order), and K9's on the CPU is index_select."""
    arrs = spaced_scene(4, P=40)
    _, tc = make_cams(SIZE)
    prep = tgs.rasterize_prep(*_t(arrs), tc, tgs.RasterizeSettings(tile=TILE))
    proj = tproject(*_t((arrs[0], arrs[3], arrs[4], arrs[2])), tc)
    lids = tgs.resident_ids(proj, SIZE, SIZE, TILE, 12)
    rows = prep.rows.detach()
    ltable = tk9.gather_rows(rows, lids)
    assert torch.equal(ltable, rows[lids.long()])
    bg = torch.linspace(0, 1, C)
    order = tgs.remap_resident(prep.order, lids, rows.shape[0])
    got = tk.forward_resident(rows, ltable, order, prep.ranges, bg, SIZE, SIZE, TILE)
    want = tk.blend_plain(rows, prep.order, prep.ranges, bg, SIZE, SIZE, TILE)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_resident_walk_is_k1_walk():
    """The plain model of what K7 walks since it shares K1's kernel: the cull
    (`cull_keep_plain`) and the culled walk (`blend_culled_plain`) on the rows
    the resident row source gives each instance (`resident_source_plain` of
    rows, rows[lids] and the remapped order) equal K1's on (rows, original
    order), bit for bit, and the blend's plain version."""
    arrs = spaced_scene(4, P=40)
    _, tc = make_cams(SIZE)
    prep = tgs.rasterize_prep(*_t(arrs), tc, tgs.RasterizeSettings(tile=TILE))
    proj = tproject(*_t((arrs[0], arrs[3], arrs[4], arrs[2])), tc)
    rows = prep.rows.detach()
    lids = tgs.resident_ids(proj, SIZE, SIZE, TILE, 12)
    ltable = tk9.gather_rows(rows, lids)
    order_r = tgs.remap_resident(prep.order, lids, rows.shape[0])
    assert (order_r >= rows.shape[0]).any()
    table, order_src = tk.resident_source_plain(rows, ltable, order_r)
    img = (SIZE, SIZE, TILE)
    keep_r = tk.cull_keep_plain(table, order_src, prep.ranges, *img)
    keep_1 = tk.cull_keep_plain(rows, prep.order, prep.ranges, *img)
    assert torch.equal(keep_r, keep_1) and not bool(keep_1.all())
    bg = torch.linspace(0, 1, C)
    got = tk.blend_culled_plain(table, order_src, prep.ranges, bg, *img)
    want = tk.blend_culled_plain(rows, prep.order, prep.ranges, bg, *img)
    plain = tk.blend_plain(rows, prep.order, prep.ranges, bg, *img)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w) and torch.equal(g, p)


def test_resident_source_clips_ids_past_the_table():
    """An id >= P + L reads the resident table's last row, as the kernel and
    the TPU kernel clip it; ids below P read the table, P + r ltable[r]."""
    rows = torch.arange(5 * tk.ROW, dtype=torch.float32).reshape(5, tk.ROW)
    ltable = -rows[[3, 1]]
    order = torch.tensor([0, 4, 5, 6, 7, 9], dtype=torch.int32)
    table, order_src = tk.resident_source_plain(rows, ltable, order)
    assert order_src.tolist() == [0, 4, 5, 6, 6, 6]
    read = table[order_src.long()]
    assert torch.equal(read[:2], rows[[0, 4]])
    assert torch.equal(read[2:], ltable[[0, 1, 1, 1]])


def _big_behind_camera(P):
    """P tiny Gaussians behind the camera: they bin nothing."""
    means = np.zeros((P, 3), np.float32)
    means[:, 2] = -3.0
    quats = np.zeros((P, 4), np.float32)
    quats[:, 0] = 1.0
    return (means, np.zeros((P, C), np.float32), np.full((P, 1), 0.5, np.float32),
            np.full((P, 3), 0.01, np.float32), quats)


LIMIT = tgs.MAX_RESIDENT_ROWS
REFUSED = {
    "vmem_classes without size_classes": (dict(vmem_classes=2), "size_classes", 8),
    "bf16_rows with vmem_classes": (dict(bf16_rows=True, size_classes=LADDER, vmem_classes=1),
                                    "bf16_rows", 8),
    "bf16_rows with streaming": (dict(bf16_rows=True, streaming=True), "bf16_rows", 8),
    "resident table over the limit": (dict(size_classes=((LIMIT + 1, 1),), vmem_classes=1),
                                      "vmem_classes table", LIMIT + 1),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_settings_raise_in_both(name):
    kw, match, P = REFUSED[name]
    arrs = _big_behind_camera(P)
    jc, tc = make_cams(32)
    # the smallest JAX binning: one tile a Gaussian, no priority window, no cull
    jst = jgs.RasterizeSettings(chunk=8, max_tiles_per_gaussian=1, priority_window=0,
                                tile_cull=False, **kw)
    with pytest.raises(ValueError, match=match):     # raised while tracing: nothing compiles
        jax.jit(lambda *a: jgs.rasterize(*a, jc, jnp.zeros(C), jst))(*_j(arrs))
    with pytest.raises(ValueError, match=match):
        tgs.rasterize(*_t(arrs), tc, torch.zeros(C), tgs.RasterizeSettings(**kw))


@pytest.mark.parametrize("kw", [dict(streaming=True),
                                dict(size_classes=LADDER, vmem_classes=1)],
                         ids=["streaming", "vmem_classes"])
def test_prep_refuses_fused_paths_in_both(kw):
    arrs = _big_behind_camera(8)
    jc, tc = make_cams(32)
    with pytest.raises(ValueError, match="default blend path"):
        jgs.rasterize_prep(*_j(arrs), jc, jgs.RasterizeSettings(chunk=8, **kw))
    with pytest.raises(ValueError, match="default blend path"):
        tgs.rasterize_prep(*_t(arrs), tc, tgs.RasterizeSettings(**kw))


def test_resident_table_at_the_limit_is_accepted():
    arrs = _big_behind_camera(LIMIT)
    _, tc = make_cams(32)
    st = tgs.RasterizeSettings(size_classes=((LIMIT, 1),), vmem_classes=1)
    color, _, _ = tgs.rasterize(*_t(arrs), tc, torch.full((C,), 0.25), st)
    assert torch.equal(color, torch.full_like(color, 0.25))


# --- the slice as a whole -----------------------------------------------------

FRAME_LADDER = ((64, 16), (192, 16), (256, 16))   # 64^2 / tile 16: caps = the whole grid


@pytest.fixture(scope="module")
def frame_scenes():
    mp = pytest.MonkeyPatch()
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        jsc = jbench.make_bench_scene(**SCENE)
    finally:
        mp.undo()
    return jsc, tbench.make_bench_scene(**SCENE, device="cpu")


def oblique_view(w2c):
    """The bench camera turned 0.8 rad about (0.6, 0.8, 0) and moved to z = 6.
    Seen head-on from z = 30 the rig's Gaussians lie in a thin band of
    depths, many at equal depths, and the JAX size-class path,
    which keys its sort on the top 26 bits of the depth and breaks ties by
    duplication order, renders another frame than its own default path;
    from here the two JAX paths agree far inside the 1e-4 held below."""
    c, s = np.cos(0.8), np.sin(0.8)
    u = np.array([0.6, 0.8, 0.0])
    k = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
    out = np.array(w2c, np.float32).copy()
    out[:3, :3] = (c * np.eye(3) + s * k + (1 - c) * np.outer(u, u)).astype(np.float32)
    out[2, 3] = 6.0
    return out


def test_frame_pipeline_resident_vs_jax_frame(frame_scenes):
    jsc, tsc = frame_scenes
    size = jsc.size
    refiner = JRefiner(image_size=size, small=True, **REFINER)
    params = jax.jit(refiner.init)(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 32)))
    target = _targets(tsc)[0]
    target["w2c"] = oblique_view(target["w2c"])
    jst = jgs.RasterizeSettings(tile=FRAME_TILE, chunk=8,
                                max_tiles_per_gaussian=(size // FRAME_TILE) ** 2,
                                size_classes=FRAME_LADDER, vmem_classes=2)
    want, _ = _jax_frames(jsc, params, [target], settings=jst)

    tref = TRefiner(image_size=size, **REFINER)
    tref.load_state_dict(refiner_state_dict_from_flax(params))
    frames = {}
    for name, st in (("resident", tgs.RasterizeSettings(tile=FRAME_TILE, size_classes=FRAME_LADDER,
                                                          vmem_classes=2)),
                     ("default", tgs.RasterizeSettings(tile=FRAME_TILE))):
        pipe = FramePipeline(tsc.ehm, tsc.faces, tref, image_size=size,
                             invtanfov=tbench.INVTANFOV, settings=st, device="cpu")
        frames[name] = pipe.render_frame(pipe.prepare_avatar(tsc.avatar), target)
    got = frames["resident"]
    for k, w in zip(("render", "raw", "invdepth"), want[0]):
        np.testing.assert_allclose(got[k].numpy(), w, atol=FRAME_ATOL, rtol=0, err_msg=k)
        assert torch.equal(got[k], frames["default"][k]), k
    assert float((got["raw"].sum(-1) > 1e-3).float().mean()) > 0.5, "the frame is background"


def test_jax_size_class_path_orders_depth_ties_by_rank():
    """A reference delta (ROADMAP.md §3): at equal depths the JAX size-class
    path sorts by duplication order, i.e. by area rank, where its presort
    path and the port sort by id. Two Gaussians at one depth in one tile,
    the later one larger: the port and the JAX presort path put id 0
    first, the JAX size-class path puts id 1 first."""
    means = np.array([[0.0, 0.0, 3.0], [0.02, 0.0, 3.0]], np.float32)
    scales = np.array([[0.02] * 3, [0.05] * 3], np.float32)
    quats = np.array([[1.0, 0, 0, 0]] * 2, np.float32)
    opac = np.full((2, 1), 0.8, np.float32)
    jc, tc = make_cams(32)

    def jorder(st):
        @jax.jit
        def run(m, s, q, o):
            jp = jproject(m, s, q, o, jc)
            return jgs.bin_gaussians(jp.mean2d, jp.depth, jp.radius_bin, jp.valid, 32, 32, st,
                                     conic=jp.conic, alpha=jp.alpha)[:2]

        ranges, order = run(*_j((means, scales, quats, opac)))
        return np.asarray(ranges), np.asarray(order)

    base = jgs.RasterizeSettings(tile=32, max_tiles_per_gaussian=1)
    ranges, order = tgs.bin_gaussians(tproject(*_t((means, scales, quats, opac)), tc), 32, 32, 32)
    assert ranges.tolist() == [0, 2] and order.tolist() == [0, 1]
    assert jorder(base)[1][:2].tolist() == [0, 1]
    assert jorder(base._replace(size_classes=((2, 1),)))[1][:2].tolist() == [1, 0]
