"""Port vs JAX: the synthetic rig (bit for bit) and the EHM forward (atol 1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.bodymodel import ehm as jehm
from guava_renderer_tpu.bodymodel import synthetic as jsyn
from guava_renderer_tpu_torch.bodymodel import ehm as tehm
from guava_renderer_tpu_torch.bodymodel import synthetic as tsyn
from guava_renderer_tpu_torch.convert import ehm_from_numpy

torch.set_num_threads(2)
ATOL = 1e-5
RIG = dict(body_side=24, head_side=10, uv_size=64)


@pytest.fixture(scope="module")
def rigs():
    """(jax rig, port rig), the JAX rig uncached."""
    jrig = jsyn.synthetic_ehm(**RIG, cache=False)
    return jrig, tsyn.synthetic_ehm(**RIG)


def _assert_same_fields(a, b):
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("part", ["smplx", "flame", "extras"])
def test_synthetic_ehm_bit_for_bit(rigs, part):
    jrig, trig = rigs
    i = ("smplx", "flame", "extras").index(part)
    _assert_same_fields(jrig[i], trig[i])


def _params(rng, n_shape, n_exp, B=2):
    def f(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    body = dict(
        shape=f(B, n_shape), body_pose=f(B, 21, 3, s=0.2), global_pose=f(B, 1, 3, s=0.2),
        left_hand_pose=f(B, 15, 3, s=0.2), right_hand_pose=f(B, 15, 3, s=0.2),
        exp=f(B, n_exp), joints_offset=f(B, 55, 3, s=0.01),
        head_scale=1.0 + f(B, 3, s=0.1), hand_scale=1.0 + f(B, 1, s=0.1),
    )
    flame = dict(shape=f(B, n_shape), exp=f(B, n_exp), jaw=f(B, 3, s=0.2),
                 eyes=f(B, 6, s=0.2), eyelids=f(B, 2, s=0.5))
    return body, flame


def test_ehm_build_and_forward(rigs):
    """FLAME branch with eyes/eyelids, head and hand scale, joint offsets;
    the port's own EhmModel.build equals the converted JAX model."""
    jrig, trig = rigs
    jm = jehm.EhmModel.build(*jrig)
    tm = tehm.EhmModel.build(*trig, device="cpu")
    tm_conv = ehm_from_numpy(jax.tree_util.tree_map(np.asarray, jm), device="cpu")
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_allclose(tm.smplx[k].numpy(), tm_conv.smplx[k].numpy(), atol=ATOL)

    body, flame = _params(np.random.default_rng(0), jrig[0].n_shape, jrig[0].n_exp)
    want = jehm.ehm_forward(
        jm, jehm.BodyParams(**{k: jnp.asarray(v) for k, v in body.items()}),
        jehm.FlameParams(**{k: jnp.asarray(v) for k, v in flame.items()}))
    for model in (tm, tm_conv):
        got = tehm.ehm_forward(
            model, tehm.BodyParams(**{k: torch.tensor(v) for k, v in body.items()}),
            tehm.FlameParams(**{k: torch.tensor(v) for k, v in flame.items()}))
        for name in tehm.EhmResult._fields:
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       atol=ATOL, rtol=0, err_msg=name)
