"""Port vs JAX: rotations, cameras and linear blend skinning (atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.core import cameras as jcam
from guava_renderer_tpu.core import lbs as jlbs
from guava_renderer_tpu.core import rotations as jrot
from guava_renderer_tpu.bodymodel.synthetic import SMPLX_PARENTS
from guava_renderer_tpu_torch.core import cameras as tcam
from guava_renderer_tpu_torch.core import lbs as tlbs
from guava_renderer_tpu_torch.core import rotations as trot

torch.set_num_threads(2)
ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _rotations(rng, n):
    """Random rotations plus near-180-degree ones about each axis, so every
    Shepperd branch of matrix_to_quat is taken."""
    aa = rng.normal(size=(n, 3))
    flips = np.eye(3)[rng.integers(0, 3, n // 2)] * (np.pi - 1e-3)
    aa[: n // 2] = flips + rng.normal(0, 1e-2, (n // 2, 3))
    return np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa, jnp.float32)))


def test_axis_angle_to_matrix():
    aa = np.random.default_rng(0).normal(size=(4, 7, 3)).astype(np.float32)
    aa[0, 0] = 0.0  # zero rotation takes the eps path
    _close(trot.axis_angle_to_matrix(_t(aa)), jrot.axis_angle_to_matrix(jnp.asarray(aa)))


def test_matrix_to_quat_branches_and_sign():
    R = _rotations(np.random.default_rng(1), 64)
    want = np.asarray(jrot.matrix_to_quat(jnp.asarray(R)))
    got = trot.matrix_to_quat(_t(R))
    _close(got, want)
    # the branch choice fixes the sign: both keep w >= 0 on the same rows
    np.testing.assert_array_equal(got.numpy()[:, 0] >= 0, want[:, 0] >= 0)


@pytest.mark.parametrize("fn", ["quat_multiply", "quat_normalize"])
def test_quaternion_ops(fn):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 3, 4)).astype(np.float32)
    b = rng.normal(size=(5, 3, 4)).astype(np.float32)
    if fn == "quat_multiply":
        _close(trot.quat_multiply(_t(a), _t(b)), jrot.quat_multiply(jnp.asarray(a), jnp.asarray(b)))
    else:
        _close(trot.quat_normalize(_t(a)), jrot.quat_normalize(jnp.asarray(a)))


def test_camera_matrices_and_ndc2pix():
    rng = np.random.default_rng(3)
    R = _rotations(rng, 2)[1]
    t = rng.normal(size=3).astype(np.float32)
    jc = jcam.Camera(R=jnp.asarray(R), t=jnp.asarray(t), tanfovx=jnp.asarray(0.4, jnp.float32),
                     tanfovy=jnp.asarray(0.3, jnp.float32), width=96, height=64)
    tc = tcam.Camera(R=_t(R), t=_t(t), tanfovx=torch.tensor(0.4), tanfovy=torch.tensor(0.3),
                     width=96, height=64)
    _close(tc.full_proj_matrix(), jc.full_proj_matrix())
    _close(tc.focal_x, jc.focal_x)
    _close(tc.focal_y, jc.focal_y)
    v = rng.normal(size=50).astype(np.float32)
    _close(tcam.ndc2pix(_t(v), 96), jcam.ndc2pix(jnp.asarray(v), 96))


def test_kinematic_levels():
    for a, b in zip(tlbs.kinematic_levels(SMPLX_PARENTS), jlbs.kinematic_levels(SMPLX_PARENTS)):
        np.testing.assert_array_equal(a, b)


def test_lbs_full_forward():
    """Axis-angle LBS with betas, pose correctives and a regressed skeleton
    on the 55-joint SMPL-X tree: every LbsResult field."""
    rng = np.random.default_rng(4)
    B, V, J, L = 2, 40, 55, 6
    pose = rng.normal(0, 0.3, (B, J, 3)).astype(np.float32)
    v_t = rng.normal(size=(V, 3)).astype(np.float32)
    w = rng.uniform(size=(V, J)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    betas = rng.normal(size=(B, L)).astype(np.float32)
    sd = (rng.normal(size=(V, 3, L)) * 0.01).astype(np.float32)
    pd = (rng.normal(size=(V, 3, (J - 1) * 9)) * 0.01).astype(np.float32)
    jreg = rng.uniform(size=(J, V)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    want = jlbs.lbs(jnp.asarray(pose), jnp.asarray(v_t), None, SMPLX_PARENTS, jnp.asarray(w),
                    betas=jnp.asarray(betas), shapedirs=jnp.asarray(sd),
                    posedirs=jnp.asarray(pd), J_regressor=jnp.asarray(jreg))
    got = tlbs.lbs(_t(pose), _t(v_t), None, SMPLX_PARENTS, _t(w), betas=_t(betas),
                   shapedirs=_t(sd), posedirs=_t(pd), J_regressor=_t(jreg))
    for name in tlbs.LbsResult._fields:
        _close(getattr(got, name), getattr(want, name))


def test_rigid_chain_with_rotmats():
    rng = np.random.default_rng(5)
    R = _rotations(rng, 2 * 55).reshape(2, 55, 3, 3)
    joints = rng.normal(size=(2, 55, 3)).astype(np.float32)
    jp, jr = jlbs.rigid_transform_chain(jnp.asarray(R), jnp.asarray(joints), SMPLX_PARENTS)
    tp, tr = tlbs.rigid_transform_chain(_t(R), _t(joints), SMPLX_PARENTS)
    _close(tp, jp)
    _close(tr, jr)
