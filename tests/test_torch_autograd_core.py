"""Port vs JAX under differentiation: rotations, the EHM forward (blend
shapes, the kinematic chain, skinning) and the deformer. The forward values of
these modules are held elsewhere; here the same scalar is differentiated in
both packages and the gradients compared within 2e-4 of the reference
gradient's largest entry (float32, sums in another order).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar import deformer as jdef
from guava_renderer_tpu.avatar.state import GaussianAvatar as JAvatar
from guava_renderer_tpu.bodymodel import ehm as jehm
from guava_renderer_tpu.bodymodel import synthetic as jsyn
from guava_renderer_tpu.core import rotations as jrot
from guava_renderer_tpu_torch.avatar import deformer as tdef
from guava_renderer_tpu_torch.bodymodel import ehm as tehm
from guava_renderer_tpu_torch.bodymodel import synthetic as tsyn
from guava_renderer_tpu_torch.convert import avatar_from_numpy
from guava_renderer_tpu_torch.core import rotations as trot

torch.set_num_threads(2)
ATOL = 2e-4


def _grad_close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got / scale, want / scale, atol=ATOL, err_msg=name)


def test_axis_angle_to_matrix_gradient():
    rng = np.random.default_rng(0)
    aa = rng.normal(size=(6, 3)).astype(np.float32)
    w = rng.normal(size=(6, 3, 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jrot.axis_angle_to_matrix(a) * w))(jnp.asarray(aa))
    a = torch.tensor(aa, requires_grad=True)
    (trot.axis_angle_to_matrix(a) * torch.tensor(w)).sum().backward()
    _grad_close(a.grad.numpy(), want)


def test_zero_rotation_has_a_finite_gradient():
    a = torch.zeros(2, 3, requires_grad=True)
    trot.axis_angle_to_matrix(a).sum().backward()
    assert bool(torch.isfinite(a.grad).all())


def test_matrix_to_quat_gradient_on_every_branch():
    """Rotations near 180 degrees about each axis take the three Shepperd
    branches that the trace does not win."""
    rng = np.random.default_rng(1)
    n = 16
    aa = rng.normal(size=(n, 3))
    aa[: n // 2] = np.eye(3)[np.arange(n // 2) % 3] * (np.pi - 1e-2) + rng.normal(0, 1e-2,
                                                                                 (n // 2, 3))
    R = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa, jnp.float32)))
    w = rng.normal(size=(n, 4)).astype(np.float32)
    want = jax.grad(lambda m: jnp.sum(jrot.matrix_to_quat(m) * w))(jnp.asarray(R))
    m = torch.tensor(R, requires_grad=True)
    (trot.matrix_to_quat(m) * torch.tensor(w)).sum().backward()
    _grad_close(m.grad.numpy(), want)


@pytest.fixture(scope="module")
def ehm_grads():
    """d(weighted vertices + joints)/d(pose, shape, expression) in both packages."""
    rig = dict(body_side=12, head_side=6, uv_size=16, n_shape=8, n_exp=4)
    jrig = jsyn.synthetic_ehm(**rig, cache=False)
    jm = jehm.EhmModel.build(*jrig)
    tm = tehm.EhmModel.build(*tsyn.synthetic_ehm(**rig), device="cpu")
    rng = np.random.default_rng(2)
    B, V = 2, jrig[0].num_vertices
    leaves = {"shape": rng.normal(size=(B, 8)), "body_pose": rng.normal(size=(B, 21, 3)) * 0.2,
              "global_pose": rng.normal(size=(B, 1, 3)) * 0.2, "exp": rng.normal(size=(B, 4)),
              "flame_exp": rng.normal(size=(B, 4)), "flame_jaw": rng.normal(size=(B, 3)) * 0.2}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    w = rng.normal(size=(B, V, 3)).astype(np.float32)

    def jloss(p):
        body = jehm.BodyParams(shape=p["shape"], body_pose=p["body_pose"],
                               global_pose=p["global_pose"], exp=p["exp"])
        flame = jehm.FlameParams(shape=jnp.zeros((B, 8)), exp=p["flame_exp"], jaw=p["flame_jaw"])
        res = jehm.ehm_forward(jm, body, flame)
        return jnp.sum(res.vertices * w) + jnp.sum(res.vertex_transforms[..., :3, :] ** 2)

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in leaves.items()})
    p = {k: torch.tensor(v, requires_grad=True) for k, v in leaves.items()}
    body = tehm.BodyParams(shape=p["shape"], body_pose=p["body_pose"],
                           global_pose=p["global_pose"], exp=p["exp"])
    flame = tehm.FlameParams(shape=torch.zeros(B, 8), exp=p["flame_exp"], jaw=p["flame_jaw"])
    res = tehm.ehm_forward(tm, body, flame)
    ((res.vertices * torch.tensor(w)).sum()
     + (res.vertex_transforms[..., :3, :] ** 2).sum()).backward()
    return {k: (p[k].grad.numpy(), np.asarray(want[k])) for k in leaves}


@pytest.mark.parametrize("name", ["shape", "body_pose", "global_pose", "exp", "flame_exp",
                                  "flame_jaw"])
def test_ehm_forward_gradient(ehm_grads, name):
    got, want = ehm_grads[name]
    _grad_close(got, want, name)


@pytest.fixture(scope="module")
def deform_grads():
    """d(weighted deformed Gaussians)/d(vertices, transforms, avatar fields)
    through the row-gather path, in both packages."""
    from guava_renderer_tpu.bodymodel.synthetic import _grid_mesh
    from guava_renderer_tpu.core.rotations import axis_angle_to_matrix

    rng = np.random.default_rng(21)
    gverts, gfaces = _grid_mesh(7, 7)
    V, F, N = gverts.shape[0], gfaces.shape[0], 256
    verts = (gverts[None] + rng.normal(0, 0.02, (1, V, 3))).astype(np.float32)
    T = np.broadcast_to(np.eye(4, dtype=np.float32), (1, V, 4, 4)).copy()
    T[..., :3, :3] = np.asarray(axis_angle_to_matrix(
        jnp.asarray(rng.normal(0, 0.3, (1, V, 3)), jnp.float32)))

    def mk(shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    def quats(n):
        q = rng.normal(size=(1, n, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    avatar = JAvatar(
        vtx_positions=verts, vtx_colors=mk((1, V, 32)), vtx_opacity=mk((1, V, 1)),
        vtx_scales=mk((1, V, 3)), vtx_rotations=quats(V), uv_local_xyz=mk((1, N, 3)),
        uv_colors=mk((1, N, 32)), uv_opacity=mk((1, N, 1)), uv_scales=mk((1, N, 3)),
        uv_rotations=quats(N), uv_binding_face=rng.integers(0, F, N).astype(np.int32),
        uv_face_bary=rng.dirichlet([1, 1, 1], N).astype(np.float32),
        uv_valid=rng.uniform(size=N) < 0.8)
    weights = {"xyz": mk((1, V + N, 3)), "rotation": mk((1, V + N, 4)),
               "scaling": mk((1, V + N, 3)), "opacity": mk((1, V + N, 1))}
    names = ("vertices", "transforms", "uv_local_xyz", "uv_scales", "uv_rotations", "uv_opacity",
             "vtx_rotations", "vtx_scales")

    def jloss(v, t, fields):
        av = jax.tree_util.tree_map(jnp.asarray, avatar)._replace(**fields)
        gs = jdef.deform_with_vertices(av, v, t, jnp.asarray(gfaces))
        return sum(jnp.sum(getattr(gs, k) * w) for k, w in weights.items())

    jfields = {k: jnp.asarray(getattr(avatar, k)) for k in names[2:]}
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(verts), jnp.asarray(T), jfields)

    tav = avatar_from_numpy(avatar, "cpu")
    tfields = {k: getattr(tav, k).clone().requires_grad_(True) for k in names[2:]}
    v = torch.tensor(verts, requires_grad=True)
    t = torch.tensor(T, requires_grad=True)
    gs = tdef.deform_with_vertices(tav._replace(**tfields), v, t, torch.tensor(gfaces).long())
    sum((getattr(gs, k) * torch.tensor(w)).sum() for k, w in weights.items()).backward()
    got = {"vertices": v.grad, "transforms": t.grad, **{k: tfields[k].grad for k in tfields}}
    want = {"vertices": jg[0], "transforms": jg[1], **jg[2]}
    return {k: (got[k].numpy(), np.asarray(want[k])) for k in names}


@pytest.mark.parametrize("name", ["vertices", "transforms", "uv_local_xyz", "uv_scales",
                                  "uv_rotations", "uv_opacity", "vtx_rotations", "vtx_scales"])
def test_deform_gradient(deform_grads, name):
    got, want = deform_grads[name]
    _grad_close(got, want, name)
