"""The training step as a whole, port against JAX, at the widths of
`testing.make_micro_pipeline` (batch 2, 28^2 source, 32^2 frames, 16^2
chart, the multi-scale L2 stand-in for LPIPS).

The same parameters (carried through `convert.model_from_flax`) and the same
batch (the same numpy draws) go through both packages. The JAX side runs its
Pallas kernels in interpret mode; its value-and-grad is compiled once for the
module. Held: the loss and every metric to rtol 1e-4; every parameter
gradient, carried through the converter, to rtol 2e-3 with atol 1e-5 of
that leaf's largest entry; and, loosely (rtol 1e-2), the loss after two
optimizer steps. Gradients are compared rather than parameters after a step:
with beta1 = 0 the first Adam update is lr * sign(g), which hides a wrong
magnitude.
"""


import jax
import numpy as np
import optax
import pytest
import torch

from guava_renderer_tpu import testing as jtesting
from guava_renderer_tpu.train.pipeline import make_loss_fn as jmake_loss_fn
from guava_renderer_tpu.train.trainstep import make_optimizer as jmake_optimizer
from guava_renderer_tpu_torch import testing as ttesting
from guava_renderer_tpu_torch.convert import model_from_flax, model_state_dict_from_flax
from guava_renderer_tpu_torch.kernels import blend as k1
from guava_renderer_tpu_torch.train.pipeline import make_loss_fn
from guava_renderer_tpu_torch.train.trainstep import (
    make_sample_scan_step, make_train_state, make_train_step)

torch.set_num_threads(2)
B = 2
LR = 1e-3
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_REL = 2e-3, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    mp.setenv("GUAVA_NO_RIG_CACHE", "1")
    try:
        jtp = jtesting.make_micro_pipeline(batch_size=B)
    finally:
        mp.undo()
    ttp = ttesting.make_micro_pipeline(batch_size=B, device="cpu")
    model_from_flax(_np(jtp.params), ttp.statics.inferer, ttp.statics.renderer)
    model = torch.nn.ModuleDict({"inferer": ttp.statics.inferer,
                                 "renderer": ttp.statics.renderer})

    jloss_fn = jmake_loss_fn(jtp.statics, None)
    vg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))
    (jloss, jmetrics), jgrads = vg(jtp.params, jtp.batch, 0)

    loss_fn = make_loss_fn(ttp.statics, None)
    model.zero_grad(set_to_none=True)
    k3_before = k1.bwd_launches
    loss, metrics = loss_fn(ttp.batch, 0)
    loss.backward()
    grads = {n: (np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy().copy())
             for n, p in model.named_parameters()}
    return dict(jtp=jtp, ttp=ttp, model=model, vg=vg, loss_fn=loss_fn,
                jloss=float(jloss), jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=_np(jgrads), loss=float(loss.detach()),
                metrics={k: float(v.detach()) for k, v in metrics.items()}, grads=grads,
                k3_launches=k1.bwd_launches - k3_before)


def test_batches_are_the_same(both):
    want = _flat(_np(both["jtp"].batch))
    got = _flat({k: v for k, v in both["ttp"].batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_loss_and_metrics(both):
    assert np.isfinite(both["loss"])
    np.testing.assert_allclose(both["loss"], both["jloss"], rtol=LOSS_RTOL)
    assert sorted(both["metrics"]) == sorted(both["jmetrics"])
    for k, want in both["jmetrics"].items():
        np.testing.assert_allclose(both["metrics"][k], want, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)


def test_jax_gradients_are_finite(both):
    """The comparison below means something only if the reference's own
    gradient is finite on this batch."""
    for k, v in _flat(both["jgrads"]).items():
        assert np.isfinite(v).all(), k


def _grad_names():
    # parameter names are fixed by the micro configuration; listed at import
    # time from a throwaway module so that every leaf is its own case
    from guava_renderer_tpu_torch.avatar.inferer import InfererConfig
    from guava_renderer_tpu_torch.train.pipeline import make_models

    cfg = InfererConfig(
        image_size=32, uvmap_size=16, invtanfov=3.0, dino_out_dim=4, uv_out_dim=8,
        smplx_fea_dim=8, prj_out_dim=8, global_vertex_dim=16, uv_base_dim=4, style_dim=32,
        num_mlp=2, channel_scale=16.0, vit_dim=64, vit_depth=5, vit_heads=4,
        pyramid_dims=(16, 16, 16, 16))
    with torch.device("meta"):
        inferer, renderer = make_models(cfg, 10, refiner_channel_scale=16.0)
    return ([f"inferer.{n}" for n, _ in inferer.named_parameters()]
            + [f"renderer.{n}" for n, _ in renderer.named_parameters()])


GRAD_NAMES = _grad_names()


def test_every_parameter_has_a_jax_gradient(both):
    want = model_state_dict_from_flax(both["jgrads"])
    assert sorted(want) == sorted(both["grads"]) == sorted(GRAD_NAMES)


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_parameter_gradient_vs_jax(both, name):
    want = model_state_dict_from_flax(both["jgrads"])[name].numpy()
    got = both["grads"][name]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * max(np.abs(want).max(), 1e-30))


def test_backbone_is_frozen_and_the_rest_is_not(both):
    dino = [n for n in GRAD_NAMES if ".dino." in n]
    assert dino and all(not both["grads"][n].any() for n in dino)
    moving = [n for n in GRAD_NAMES if ".dino." not in n and "noise_weight" not in n]
    dead = [n for n in moving if not both["grads"][n].any()]
    assert len(dead) < len(moving) // 10, dead


def test_backward_went_through_the_blend_backward_once_per_item(both):
    # on CPU tensors the plain version runs and no kernel launch is counted
    assert both["k3_launches"] == 0


def test_loss_after_two_steps(both):
    """Two optimizer steps in both packages, then the loss.

    The scale regulariser is taken with threshold 0 here. With the default
    0.6 a texel whose three scales are all under it sits at the origin of
    the norm after the first step: JAX differentiates that to NaN, which
    reaches every parameter upstream of the UV decoder and is scrubbed to
    zero, so its second step leaves the UV branch where it was, while the
    port's norm has the zero subgradient there (as PyTorch's has in the
    reference implementation) and trains on. Scales are exponentials, so
    with threshold 0 neither side meets the origin and the two runs stay
    comparable."""
    jtp, ttp = both["jtp"], both["ttp"]
    jcfg = jtp.statics.loss_cfg._replace(threshold_scale=0.0)
    vg = jax.jit(jax.value_and_grad(
        jmake_loss_fn(jtp.statics._replace(loss_cfg=jcfg), None), has_aux=True))
    opt = jmake_optimizer(jtp.params, learning_rate=LR)
    params, opt_state = jtp.params, opt.init(jtp.params)
    jlosses = []
    for it in range(2):
        (jl, _), g = vg(params, jtp.batch, it)
        assert all(np.isfinite(v).all() for v in _flat(_np(g)).values()), it
        jlosses.append(float(jl))
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    (jloss2, _), _ = vg(params, jtp.batch, 2)

    tcfg = ttp.statics.loss_cfg._replace(threshold_scale=0.0)
    loss_fn = make_loss_fn(ttp.statics._replace(loss_cfg=tcfg), None)
    state = make_train_state(both["model"], learning_rate=LR)
    step = make_train_step(loss_fn, state)
    losses = [float(step(ttp.batch)[0]) for _ in range(2)]
    with torch.no_grad():
        loss2, _ = loss_fn(ttp.batch, 2)
    assert state.iteration == 2
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss2), float(jloss2), rtol=1e-2)
    assert float(loss2) < losses[0]


def test_accumulated_step_equals_batched_step():
    """The per-sample accumulation step against the batched step, in the
    port, from the same weights: same loss, same updated parameters."""
    results = []
    for make in (make_train_step, make_sample_scan_step):
        tp = ttesting.make_micro_pipeline(batch_size=B, seed=1, device="cpu")
        model = torch.nn.ModuleDict({"inferer": tp.statics.inferer,
                                     "renderer": tp.statics.renderer})
        state = make_train_state(model, learning_rate=LR)
        loss, _ = make(make_loss_fn(tp.statics, None), state)(tp.batch)
        results.append((float(loss), {n: p.detach().clone()
                                      for n, p in model.named_parameters()}))
    (l0, p0), (l1, p1) = results
    np.testing.assert_allclose(l0, l1, rtol=1e-5)
    moved = 0
    for n in p0:
        # an update is +-lr where the two gradients agree in sign; they may
        # differ where a gradient is at rounding level
        same = (p0[n] - p1[n]).abs() <= 1e-6
        assert float(same.float().mean()) > 0.98, n
        moved += int(same.numel())
    assert moved > 0


def test_remat_gives_the_same_gradients():
    tp = ttesting.make_micro_pipeline(batch_size=1, seed=2, device="cpu")
    model = torch.nn.ModuleDict({"inferer": tp.statics.inferer, "renderer": tp.statics.renderer})
    grads = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = make_loss_fn(tp.statics, None, remat=remat)(tp.batch, 0)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert sorted(grads[0]) == sorted(grads[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=1e-5, atol=1e-8, msg=n)
