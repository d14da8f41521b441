"""Port vs JAX: the plain version of K4 (the face-gather backward) against
`jax.grad` through `face_window_gather` (Pallas backward in interpret mode),
the plan's segment starts that the CUDA kernel walks, and the gradient of the
planned deform path against the default path's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import facegather as jfg
from guava_renderer_tpu_torch.avatar import deformer as tdef
from guava_renderer_tpu_torch.avatar.state import GaussianAvatar
from guava_renderer_tpu_torch.bodymodel.synthetic import _grid_mesh
from guava_renderer_tpu_torch.convert import plan_from_numpy
from guava_renderer_tpu_torch.kernels import facegather as tk2
from guava_renderer_tpu_torch.ops import facegather as tfg

torch.set_num_threads(2)

PLANS = {
    # name: (N texels, F faces, share of valid texels)
    "mixed": (2048, 300, 0.8),
    "uneven": (256 * 3, 100, 0.8),
    "all_valid": (512, 40, 1.1),
    "sparse_faces": (512, 4000, 0.5),     # most faces bind no texel
}


@pytest.fixture(scope="module", params=sorted(PLANS))
def case(request):
    N, F, valid_frac = PLANS[request.param]
    rng = np.random.default_rng(3)
    binding = rng.integers(0, F, N)
    valid = rng.uniform(size=N) < valid_frac
    jplan = jfg.build_face_sort_plan(binding, valid)
    tplan = tfg.build_face_sort_plan(binding, valid)
    table = rng.normal(size=(jplan.n_compact, 16)).astype(np.float32)
    w = rng.normal(size=(16, N)).astype(np.float32)
    return dict(jplan=jplan, tplan=tplan, table=table, w=w, binding=binding, valid=valid)


def test_plain_backward_vs_jax_grad(case):
    """d_table of sum(gather(table) * w): the plain K4 through the autograd
    Function against jax.grad through the Pallas kernel pair. The JAX kernel
    sums a face's texels with a one-hot matrix product, the plain version in
    texel order, and the dummy face sums some 400 unit normals: atol 1e-4,
    the tolerance of tests/test_facegather.py."""
    jp = case["jplan"]
    ids = jnp.asarray(jp.compact_ids)
    want = jax.grad(lambda t: jnp.sum(jfg.face_window_gather(t, ids, jp) * jnp.asarray(case["w"])))(
        jnp.asarray(case["table"]))
    table = torch.tensor(case["table"], requires_grad=True)
    tp = case["tplan"].to("cpu")
    before = tk2.bwd_launches
    rows = tk2.face_gather(table, tp.compact_ids, tp.segment_starts)
    (rows * torch.tensor(case["w"])).sum().backward()
    np.testing.assert_allclose(table.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert tk2.bwd_launches == before, "the CPU path must not count kernel launches"


def test_segment_starts_describe_the_sorted_ids(case):
    tp = case["tplan"]
    seg, ids = tp.segment_starts, tp.compact_ids
    assert seg.dtype == np.int32 and seg.shape == (tp.n_compact + 1,)
    assert seg[0] == 0 and seg[-1] == tp.n_texels and np.all(np.diff(seg) >= 0)
    for f in (0, 1, tp.n_compact // 2, tp.n_compact - 1):
        assert np.all(ids[seg[f]:seg[f + 1]] == f)
    assert np.diff(seg).sum() == tp.n_texels
    # the dummy face's segment holds exactly the invalid texels
    assert seg[-1] - seg[-2] == int((~case["valid"]).sum())
    np.testing.assert_array_equal(plan_from_numpy(case["jplan"]).segment_starts, seg)


def test_segmented_sum_equals_plain_backward(case):
    """What the CUDA kernel computes (each face sums its segment of drows in
    ascending texel order) equals the plain version bit for bit."""
    tp = case["tplan"]
    drows = case["w"]
    seg = tp.segment_starts
    want = tk2.face_gather_bwd_plain(torch.tensor(drows), torch.tensor(tp.compact_ids),
                                     tp.n_compact).numpy()
    got = np.zeros((tp.n_compact, 16), np.float32)
    for f in range(tp.n_compact):
        acc = np.zeros(16, np.float32)
        for t in range(seg[f], seg[f + 1]):
            acc = acc + drows[:, t]
        got[f] = acc
    np.testing.assert_array_equal(got, want)


def test_backward_function_on_cpu_is_the_plain_version(case):
    tp = case["tplan"].to("cpu")
    drows = torch.tensor(case["w"])
    got = tk2.face_gather_bwd(drows, tp.compact_ids, None, tp.n_compact)   # no seg needed on CPU
    want = tk2.face_gather_bwd_plain(drows, tp.compact_ids, tp.n_compact)
    assert torch.equal(got, want)


# ---- K4's windowed order (csrc/facegather_bwd.cu) in its plain model ----

# K4 against the sequential sum, per face: within this share of the face's
# sum of |drows| (the chip run holds the kernel to it against index_add_)
K4_TOL = 1e-6
WINDOW = tk2.WINDOW


WINDOWED_PLANS = {
    # name: (binding, valid), each from a seeded draw; N a multiple of 256, as plans require
    # the dummy face: 1,536 invalid texels against 2,560 valid ones on 320 faces (192x the
    # mean real segment), over six windows
    "dummy_heavy": lambda rng: (rng.integers(0, 320, 4096), np.arange(4096) < 2560),
    # every texel binds one face: sixteen windows, no face starts in fifteen of them
    "one_face": lambda rng: (np.full(4096, 7), np.ones(4096, bool)),
    # Fc = 1: every texel invalid, all on the dummy face
    "only_dummy": lambda rng: (rng.integers(0, 50, 3072), np.zeros(3072, bool)),
    # segments of 1 to ~60 texels
    "geometric": lambda rng: (np.minimum(rng.geometric(0.05, 3328), 400),
                              rng.uniform(size=3328) < 0.9),
    # all valid: the dummy face's segment is empty
    "empty_dummy": lambda rng: (rng.integers(0, 700, 2048), np.ones(2048, bool)),
}


@pytest.fixture(scope="module", params=sorted(WINDOWED_PLANS))
def windowed_case(request):
    rng = np.random.default_rng(17)
    binding, valid = WINDOWED_PLANS[request.param](rng)
    jplan = jfg.build_face_sort_plan(binding, valid)
    tplan = tfg.build_face_sort_plan(binding, valid)
    w = rng.normal(size=(16, tplan.n_texels)).astype(np.float32)
    return dict(name=request.param, jplan=jplan, tplan=tplan, w=w)


def _windowed(tp, drows):
    return tk2.face_gather_bwd_windowed_plain(drows, torch.as_tensor(tp.compact_ids),
                                              torch.as_tensor(tp.segment_starts), tp.n_compact)


def _assert_within_k4_tol(got, drows, ids, n_faces):
    want = tk2.face_gather_bwd_plain(drows, ids, n_faces)
    room = K4_TOL * tk2.face_gather_bwd_plain(drows.abs(), ids, n_faces)
    assert bool(((got - want).abs() <= room).all()), float((got - want).abs().max())


def test_windowed_cases_hold_what_they_name(windowed_case):
    tp = windowed_case["tplan"]
    lengths = np.diff(tp.segment_starts)
    crossings = len({int(tp.compact_ids[t]) for t in range(WINDOW, tp.n_texels, WINDOW)
                     if tp.compact_ids[t - 1] == tp.compact_ids[t]})
    name = windowed_case["name"]
    if name == "dummy_heavy":
        assert lengths[-1] >= 100 * lengths[:-1].mean() and crossings >= 1
    elif name in ("one_face", "only_dummy"):
        assert lengths.max() == tp.n_texels and tp.n_texels >= 3 * WINDOW
        assert tp.n_compact == (1 if name == "only_dummy" else 2)
    elif name == "geometric":
        assert lengths[:-1].max() > 2 * lengths[:-1].mean() and crossings >= 1
    else:
        assert lengths[-1] == 0


def test_windowed_backward_vs_plain(windowed_case):
    """The kernel's order against the sequential sum (index_add_ on the CPU),
    within K4_TOL of each face's sum of |drows|."""
    tp = windowed_case["tplan"]
    drows = torch.tensor(windowed_case["w"])
    _assert_within_k4_tol(_windowed(tp, drows), drows, torch.as_tensor(tp.compact_ids),
                          tp.n_compact)


def test_windowed_backward_vs_jax_grad(windowed_case):
    """The kernel's order against jax.grad through the Pallas kernel pair (in
    interpret mode), as test_plain_backward_vs_jax_grad holds the plain
    version."""
    jp = windowed_case["jplan"]
    ids = jnp.asarray(jp.compact_ids)
    w = windowed_case["w"]
    table = np.zeros((jp.n_compact, 16), np.float32)
    want = jax.grad(lambda t: jnp.sum(jfg.face_window_gather(t, ids, jp) * jnp.asarray(w)))(
        jnp.asarray(table))
    got = _windowed(windowed_case["tplan"], torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_windowed_backward_is_deterministic(windowed_case):
    tp = windowed_case["tplan"]
    drows = torch.tensor(windowed_case["w"])
    assert torch.equal(_windowed(tp, drows), _windowed(tp, drows))


@pytest.mark.parametrize("n,n_faces", [(5000, 600), (777, 50), (130, 400), (1, 3), (6149, 20),
                                       (2560, 9)])
def test_windowed_backward_with_empty_segments(n, n_faces):
    """Sorted ids that leave faces unbound before, between and after the
    bound ones (not only the dummy face): those faces get zeros. N is mostly
    no multiple of the window, and few faces on many texels cross several
    windows each."""
    rng = np.random.default_rng(n)
    ids = np.sort(rng.integers(0, n_faces, n))
    ids[ids == n_faces // 2] = n_faces // 2 + 1
    seg = torch.as_tensor(tfg.segment_starts(ids, n_faces))
    assert bool((seg[1:] == seg[:-1]).any())
    drows = torch.tensor(rng.normal(size=(16, n)).astype(np.float32))
    it = torch.as_tensor(ids, dtype=torch.int32)
    got = tk2.face_gather_bwd_windowed_plain(drows, it, seg, n_faces)
    _assert_within_k4_tol(got, drows, it, n_faces)
    empty = (seg[1:] == seg[:-1]).nonzero().flatten()
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_backward_rejects_bad_inputs(bad):
    ids = torch.zeros(8, dtype=torch.int32)
    drows = torch.zeros(16, 8) if bad == "dtype" else torch.zeros(8, 16)
    if bad == "dtype":
        drows = drows.double()
    with pytest.raises(ValueError):
        tk2.face_gather_bwd(drows, ids, None, 4)


# ---- the planned deform path's gradient against the default path's ----

FIELDS = ("vtx_colors", "vtx_opacity", "vtx_scales", "vtx_rotations",
          "uv_local_xyz", "uv_colors", "uv_opacity", "uv_scales", "uv_rotations")


@pytest.fixture(scope="module")
def deform_grads():
    """Gradients of one scalar of the deformed Gaussians with respect to the
    posed vertices and every float field of a face-sorted avatar, through the
    row-gather path and through the planned path (K2 forward, K4 backward;
    their plain versions here). All texels valid: an invalid texel binds a
    different face in the two paths."""
    rng = np.random.default_rng(21)
    gverts, gfaces = _grid_mesh(9, 9)
    V, F, N = gverts.shape[0], gfaces.shape[0], 512
    verts = (gverts[None] + rng.normal(0, 0.02, (1, V, 3))).astype(np.float32)
    T = np.broadcast_to(np.eye(4, dtype=np.float32), (1, V, 4, 4)).copy()

    def mk(shape):
        return torch.tensor(rng.normal(0, 1, shape).astype(np.float32))

    def quats(n):
        q = rng.normal(size=(1, n, 4)).astype(np.float32)
        return torch.tensor(q / np.linalg.norm(q, axis=-1, keepdims=True))

    binding = rng.integers(0, F, N)
    valid = np.ones(N, bool)
    avatar = GaussianAvatar(
        vtx_positions=torch.tensor(verts), vtx_colors=mk((1, V, 32)), vtx_opacity=mk((1, V, 1)),
        vtx_scales=mk((1, V, 3)), vtx_rotations=quats(V), uv_local_xyz=mk((1, N, 3)),
        uv_colors=mk((1, N, 32)), uv_opacity=mk((1, N, 1)), uv_scales=mk((1, N, 3)),
        uv_rotations=quats(N), uv_binding_face=torch.tensor(binding, dtype=torch.int64),
        uv_face_bary=torch.tensor(rng.dirichlet([1, 1, 1], N).astype(np.float32)),
        uv_valid=torch.tensor(valid))
    plan = tfg.build_face_sort_plan(binding, valid)
    sorted_av = tdef.sort_avatar_by_plan(avatar, plan)
    faces = torch.tensor(gfaces).long()
    cfaces = torch.tensor(tfg.compact_faces(plan, gfaces)).long()
    weights = {name: mk(shape) for name, shape in (
        ("xyz", (1, V + N, 3)), ("rotation", (1, V + N, 4)), ("scaling", (1, V + N, 3)),
        ("opacity", (1, V + N, 1)), ("colors", (1, V + N, 32)))}

    out = {}
    for path in ("rows", "planned"):
        leaves = {f: getattr(sorted_av, f).clone().requires_grad_(True) for f in FIELDS}
        v = torch.tensor(verts, requires_grad=True)
        av = sorted_av._replace(**leaves)
        kw = dict(plan=plan.to("cpu"), compact_faces=cfaces) if path == "planned" else {}
        gs = tdef.deform_with_vertices(av, v, torch.tensor(T), faces, **kw)
        loss = sum((getattr(gs, k) * w).sum() for k, w in weights.items())
        loss.backward()
        out[path] = dict(loss=float(loss.detach()), vertices=v.grad.numpy(),
                         **{f: leaves[f].grad.numpy() for f in FIELDS})
    return out


def test_planned_deform_loss_equals_default(deform_grads):
    np.testing.assert_allclose(deform_grads["planned"]["loss"], deform_grads["rows"]["loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("name", ("vertices",) + FIELDS)
def test_planned_deform_gradient_equals_default(deform_grads, name):
    got, want = deform_grads["planned"][name], deform_grads["rows"][name]
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_degenerate_face_has_a_finite_gradient():
    """A face whose three vertices coincide: the frame's norms are clamped
    under the square root, so the gradient is finite (zero), not NaN."""
    tri = torch.zeros(2, 3, 3)
    tri[1] = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    tri.requires_grad_(True)
    table = tdef._face_table(tri)
    assert bool(torch.isfinite(table).all())
    table.sum().backward()
    assert bool(torch.isfinite(tri.grad).all())
    assert tri.grad[1].abs().max() > 0
