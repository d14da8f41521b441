"""Port vs JAX: the face-sort plan, the plain K2 gather and both deform paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar import deformer as jdef
from guava_renderer_tpu.avatar.state import GaussianAvatar as JAvatar
from guava_renderer_tpu.bodymodel.synthetic import _grid_mesh
from guava_renderer_tpu.ops import facegather as jfg
from guava_renderer_tpu_torch.avatar import deformer as tdef
from guava_renderer_tpu_torch.convert import avatar_from_numpy, plan_from_numpy
from guava_renderer_tpu_torch.kernels import facegather as tk2
from guava_renderer_tpu_torch.ops import facegather as tfg

torch.set_num_threads(2)
ATOL = 1e-5


@pytest.fixture(scope="module")
def case():
    """A B=1 avatar on a jittered grid mesh, 20% invalid texels, its plan in
    both packages, and deformed vertices with per-vertex rotations."""
    rng = np.random.default_rng(21)
    gverts, gfaces = _grid_mesh(9, 9)
    V, F, N = gverts.shape[0], gfaces.shape[0], 512
    verts = (gverts[None] + rng.normal(0, 0.02, (1, V, 3))).astype(np.float32)
    aa = rng.normal(0, 0.3, (1, V, 3)).astype(np.float32)
    T = np.broadcast_to(np.eye(4, dtype=np.float32), (1, V, 4, 4)).copy()
    from guava_renderer_tpu.core.rotations import axis_angle_to_matrix
    T[..., :3, :3] = np.asarray(axis_angle_to_matrix(jnp.asarray(aa)))

    def mk(shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    def quats(n):
        q = rng.normal(size=(1, n, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    binding = rng.integers(0, F, N)
    valid = rng.uniform(size=N) < 0.8
    avatar = JAvatar(
        vtx_positions=verts, vtx_colors=mk((1, V, 32)), vtx_opacity=mk((1, V, 1)),
        vtx_scales=mk((1, V, 3)), vtx_rotations=quats(V),
        uv_local_xyz=mk((1, N, 3)), uv_colors=mk((1, N, 32)), uv_opacity=mk((1, N, 1)),
        uv_scales=mk((1, N, 3)), uv_rotations=quats(N),
        uv_binding_face=binding.astype(np.int32),
        uv_face_bary=rng.dirichlet([1, 1, 1], N).astype(np.float32),
        uv_valid=valid,
    )
    jplan = jfg.build_face_sort_plan(binding, valid)
    tplan = tfg.build_face_sort_plan(binding, valid)
    return dict(avatar=avatar, verts=verts, T=T, faces=gfaces, jplan=jplan, tplan=tplan)


def test_plan_arrays_equal(case):
    jp, tp = case["jplan"], case["tplan"]
    for name in ("perm", "inv_perm", "compact_ids", "used_faces"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)
    assert (tp.n_texels, tp.n_compact) == (jp.n_texels, jp.n_compact)
    np.testing.assert_array_equal(tfg.compact_faces(tp, case["faces"]),
                                  jfg.compact_faces(jp, case["faces"]))
    conv = plan_from_numpy(jp)
    np.testing.assert_array_equal(conv.compact_ids, tp.compact_ids)


def test_plain_gather_equals_pallas_interpret(case):
    """The plain K2 equals JAX face_window_gather (Pallas, interpret) exactly."""
    jp = case["jplan"]
    table = np.random.default_rng(3).normal(size=(jp.n_compact, 16)).astype(np.float32)
    want = jfg.face_window_gather(jnp.asarray(table), jnp.asarray(jp.compact_ids), jp)
    before = tk2.launches
    got = tk2.face_gather(torch.tensor(table), torch.tensor(jp.compact_ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tk2.launches == before, "the CPU path must not count kernel launches"


@pytest.mark.parametrize("bad", ["table_dtype", "table_width", "ids_dtype"])
def test_gather_rejects_bad_inputs(bad):
    table = torch.zeros(8, 16)
    ids = torch.zeros(4, dtype=torch.int32)
    if bad == "table_dtype":
        table = table.double()
    elif bad == "table_width":
        table = torch.zeros(8, 12)
    else:
        ids = ids.long()
    with pytest.raises(ValueError):
        tk2.face_gather(table, ids)


def test_sort_avatar_by_plan_equal(case):
    jav = jdef.sort_avatar_by_plan(case["avatar"], case["jplan"])
    tav = tdef.sort_avatar_by_plan(avatar_from_numpy(case["avatar"], "cpu"), case["tplan"])
    for name in JAvatar._fields:
        np.testing.assert_array_equal(getattr(tav, name).numpy(), np.asarray(getattr(jav, name)),
                                      err_msg=name)


def test_deform_paths_vs_jax(case):
    """Planned and row-gather deforms in the port agree with each other and
    with the JAX deform_with_vertices on the face-sorted avatar."""
    jp, tp = case["jplan"], case["tplan"]
    jav = jdef.sort_avatar_by_plan(jax.tree_util.tree_map(jnp.asarray, case["avatar"]), jp)
    tav = tdef.sort_avatar_by_plan(avatar_from_numpy(case["avatar"], "cpu"), tp)
    jverts, jT = jnp.asarray(case["verts"]), jnp.asarray(case["T"])
    tverts, tT = torch.tensor(case["verts"]), torch.tensor(case["T"])
    faces = case["faces"]
    jcf = jnp.asarray(jfg.compact_faces(jp, faces))
    tcf = torch.tensor(tfg.compact_faces(tp, faces)).long()

    want_row = jdef.deform_with_vertices(jav, jverts, jT, jnp.asarray(faces))
    want_plan = jdef.deform_with_vertices(jav, jverts, jT, jnp.asarray(faces),
                                          plan=jp, compact_faces=jcf)
    got_row = tdef.deform_with_vertices(tav, tverts, tT, torch.tensor(faces).long())
    got_plan = tdef.deform_with_vertices(tav, tverts, tT, torch.tensor(faces).long(),
                                         plan=tp.to("cpu"), compact_faces=tcf)

    V = case["verts"].shape[1]
    valid = np.concatenate([np.ones(V, bool), tav.uv_valid.numpy()])
    for name in ("xyz", "rotation", "scaling", "opacity", "colors"):
        rp, rr = getattr(got_plan, name).numpy()[0], getattr(got_row, name).numpy()[0]
        # invalid texels bind the plan's dummy face: opacity 0, geometry free
        sel = slice(None) if name in ("opacity", "colors") else valid
        np.testing.assert_allclose(rp[sel], rr[sel], atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(rr, np.asarray(getattr(want_row, name))[0], atol=ATOL,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(rp, np.asarray(getattr(want_plan, name))[0], atol=ATOL,
                                   rtol=0, err_msg=name)


# plans like the CUDA gather's edge cases on the card (chip_smoke.py K2_EDGE_CASES, which
# also take N % 4 != 0 straight to the kernel): N texels (a multiple of 256, as the JAX
# plan needs) binding Fc faces, sorted by the plan into runs of one face, a new face at
# every texel, or one face throughout
PLAN_CASES = ((5120, 600, "random"), (4352, 600, "random"), (256, 20, "random"),
              (4096, 1, "one face"), (4096, 2, "random"), (4096, 4096, "each texel"))


@pytest.mark.parametrize("n,n_faces,kind", PLAN_CASES)
def test_plain_gather_equals_pallas_on_plans(n, n_faces, kind):
    rng = np.random.default_rng(n + n_faces)
    if kind == "one face":
        binding = np.zeros(n, np.int64)
    elif kind == "each texel":
        binding = rng.permutation(n) % n_faces
    else:
        binding = rng.integers(0, n_faces, n)
    valid = rng.uniform(size=n) < 0.9
    jp = jfg.build_face_sort_plan(binding, valid)
    tp = tfg.build_face_sort_plan(binding, valid)
    np.testing.assert_array_equal(tp.compact_ids, jp.compact_ids)
    table = rng.normal(size=(jp.n_compact, 16)).astype(np.float32)
    want = jfg.face_window_gather(jnp.asarray(table), jnp.asarray(jp.compact_ids), jp)
    got = tk2.face_gather(torch.tensor(table), torch.tensor(tp.compact_ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
