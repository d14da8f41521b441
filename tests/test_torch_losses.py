"""Port vs JAX: SSIM / PSNR / MAE, LPIPS with converted weights, the crop
resample, and `OptimizationLoss` (value, every term and the gradient with
respect to the renders) before, at and after its iteration thresholds.

Tolerances: float32 sums of up to 64 x 64 x 3 x 256 terms in another order
(XLA's convolutions against PyTorch's) -> rtol 1e-4 on values, and gradients
within 2e-4 of the reference gradient's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.ops import ssim as jssim
from guava_renderer_tpu.train import losses as jlosses
from guava_renderer_tpu.train.lpips import LPIPS as JLPIPS
from guava_renderer_tpu_torch.convert import lpips_from_flax
from guava_renderer_tpu_torch.ops import ssim as tssim
from guava_renderer_tpu_torch.train import losses as tlosses
from guava_renderer_tpu_torch.train.lpips import LPIPS, init_lpips_
from guava_renderer_tpu_torch.train.pipeline import multiscale_l2

torch.set_num_threads(2)
RTOL = 1e-4
GRAD_ATOL = 2e-4


def _images(seed, shape=(2, 32, 32, 3), noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


def _grad_close(got, want):
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_ATOL)


# ---- ssim / psnr / mae ----

@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_vs_jax(size_average):
    a, b = _images(1)
    want = jssim.ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average)
    got = tssim.ssim(torch.tensor(a), torch.tensor(b), size_average=size_average)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


def test_ssim_identity_and_gradient():
    a, b = _images(2)
    assert float(tssim.ssim(torch.tensor(a), torch.tensor(a))) == pytest.approx(1.0, abs=1e-5)
    want = jax.grad(lambda x: jssim.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    tssim.ssim(x, torch.tensor(b)).backward()
    _grad_close(x.grad.numpy(), np.asarray(want))


def test_psnr_and_mae_vs_jax():
    a, b = _images(3)
    np.testing.assert_allclose(tssim.psnr(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(jssim.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(float(tssim.mae(torch.tensor(a), torch.tensor(b))),
                               float(jssim.mae(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    zero, tenth = torch.zeros(1, 8, 8, 3), torch.full((1, 8, 8, 3), 0.1)
    assert float(tssim.psnr(zero, tenth)[0]) == pytest.approx(20.0, abs=1e-4)


# ---- LPIPS ----

@pytest.fixture(scope="module", params=["alex", "vgg"])
def lpips_pair(request):
    net = request.param
    jm = JLPIPS(net_type=net)
    x0 = jnp.zeros((1, 64, 64, 3))
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0), x0, x0)
    tm = lpips_from_flax(jax.tree_util.tree_map(np.asarray, jparams), net, device="cpu")
    japply = jax.jit(jm.apply)
    jgrad = jax.jit(jax.grad(lambda x, y: jm.apply(jparams, x, y)))
    return dict(net=net, jparams=jparams, japply=japply, jgrad=jgrad, tm=tm)


@pytest.mark.parametrize("size", [64, 24])      # 24: under the 32-pixel floor, upsampled
def test_lpips_value_vs_jax(lpips_pair, size):
    p = lpips_pair
    a, b = _images(4, (2, size, size, 3), noise=0.3)
    want = float(p["japply"](p["jparams"], jnp.asarray(a), jnp.asarray(b)))
    got = float(p["tm"](torch.tensor(a), torch.tensor(b)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert float(p["tm"](torch.tensor(a), torch.tensor(a))) == pytest.approx(0.0, abs=1e-6)


def test_lpips_input_gradient_vs_jax(lpips_pair):
    p = lpips_pair
    a, b = _images(5, (1, 64, 64, 3), noise=0.3)
    want = np.asarray(p["jgrad"](jnp.asarray(a), jnp.asarray(b)))
    x = torch.tensor(a, requires_grad=True)
    p["tm"](x, torch.tensor(b)).backward()
    _grad_close(x.grad.numpy(), want)


def test_lpips_is_frozen(lpips_pair):
    tm = lpips_pair["tm"]
    assert not any(q.requires_grad for q in tm.parameters())
    assert not tm.training


def test_lpips_random_init_is_seeded_and_nonnegative():
    m1 = init_lpips_(LPIPS("alex"), torch.Generator().manual_seed(3))
    m2 = init_lpips_(LPIPS("alex"), torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(p, q), n
    a, b = _images(6, (1, 64, 64, 3), noise=0.3)
    assert float(m1(torch.tensor(a), torch.tensor(b))) > 0
    assert all(float(getattr(m1, f"lin{i}").weight.min()) >= 0 for i in range(5))
    with pytest.raises(ValueError):
        LPIPS("resnet")


# ---- crop_resample ----

def test_crop_resample_vs_jax_and_plain_resize():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    boxes = np.asarray([[0, 32, 0, 32], [3, 20, 5, 29]], np.int32)
    want = jlosses.crop_resample(jnp.asarray(img), jnp.asarray(boxes), 16)
    got = tlosses.crop_resample(torch.tensor(img), torch.tensor(boxes), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # a full-image box at an exact 2x downscale is 2x2 average pooling
    np.testing.assert_allclose(got.numpy()[0], img[0].reshape(16, 2, 16, 2, 3).mean(axis=(1, 3)),
                               atol=1e-5)
    # a box of the crop's own size reproduces the region
    same = tlosses.crop_resample(torch.tensor(img), torch.tensor([[0, 16, 0, 16]] * 2), 16)
    np.testing.assert_allclose(same.numpy(), img[:, :16, :16], atol=1e-5)


def test_crop_resample_gradient_vs_jax():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    box = np.asarray([[-2, 20, 5, 34]], np.int32)        # past the border: clamped samples
    want = jax.grad(lambda x: jnp.sum(jlosses.crop_resample(x, jnp.asarray(box), 16) * w))(
        jnp.asarray(img))
    x = torch.tensor(img, requires_grad=True)
    (tlosses.crop_resample(x, torch.tensor(box), 16) * torch.tensor(w)).sum().backward()
    _grad_close(x.grad.numpy(), np.asarray(want))


# ---- OptimizationLoss ----

def test_loss_config_defaults_equal():
    assert tlosses.LossConfig()._asdict() == jlosses.LossConfig()._asdict()


def _loss_inputs(size=64):
    rng = np.random.default_rng(11)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)   # noqa: E731
    mask = (rng.uniform(size=(2, size, size, 1)) > 0.3).astype(np.float32)
    boxes = {"head_box": np.asarray([[8, 56, 0, 32]] * 2, np.int32),
             "left_hand_box": np.asarray([[0, 24, 32, 64]] * 2, np.int32),
             "right_hand_box": np.asarray([[40, 64, 32, 64]] * 2, np.int32)}
    xyz = (rng.normal(size=(2, 100, 3)) * 3).astype(np.float32)
    scales = f(2, 100, 3) * 1.2
    return f(2, size, size, 3), f(2, size, size, 3), f(2, size, size, 3), mask, boxes, xyz, scales


@pytest.fixture(scope="module", params=["lpips", "multiscale_l2"])
def loss_pair(request):
    cfg = dict(crop_size=32, perpetual_increase_iter=10000, mask_renders_until=1000)
    if request.param == "lpips":
        jm = JLPIPS(net_type="alex")
        x0 = jnp.zeros((1, 64, 64, 3))
        jparams = jax.jit(jm.init)(jax.random.PRNGKey(1), x0, x0)
        jperc = lambda a, b: jm.apply(jparams, a, b)          # noqa: E731
        tperc = lpips_from_flax(jax.tree_util.tree_map(np.asarray, jparams), "alex", device="cpu")
    else:
        def jperc(a, b):
            def down4(x):
                return jax.image.resize(
                    x, (x.shape[0], x.shape[1] // 4, x.shape[2] // 4, x.shape[3]), "linear")
            return jnp.mean((a - b) ** 2) + jnp.mean((down4(a) - down4(b)) ** 2)
        tperc = multiscale_l2
    jloss = jlosses.OptimizationLoss(jlosses.LossConfig(**cfg), jperc)
    tloss = tlosses.OptimizationLoss(tlosses.LossConfig(**cfg), tperc)
    renders, raw, gt, mask, boxes, xyz, scales = _loss_inputs()
    jboxes = {k: jnp.asarray(v) for k, v in boxes.items()}

    def jfn(r, rw, x, s, it):
        return jloss(r, rw, jnp.asarray(gt), jnp.asarray(mask), jboxes, x, s, it)

    jvg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True))

    def tfn(it, with_boxes=True, with_raw=True):
        leaves = [torch.tensor(a, requires_grad=True) for a in (renders, raw, xyz, scales)]
        tb = {k: torch.tensor(v) for k, v in boxes.items()} if with_boxes else None
        total, terms = tloss(leaves[0], leaves[1] if with_raw else None, torch.tensor(gt),
                             torch.tensor(mask), tb, leaves[2], leaves[3], it)
        total.backward()
        return float(total.detach()), {k: float(v.detach()) for k, v in terms.items()}, \
            [None if a.grad is None else a.grad.numpy() for a in leaves]

    args = tuple(jnp.asarray(a) for a in (renders, raw, xyz, scales))
    return dict(jvg=jvg, tfn=tfn, args=args)


@pytest.mark.parametrize("it", [0, 1000, 10001])
def test_optimization_loss_vs_jax(loss_pair, it):
    """iteration 0 masks the renders and takes the low perceptual weight,
    1000 stops masking, 10001 takes the high weight."""
    (jtotal, jterms), jgrads = loss_pair["jvg"](*loss_pair["args"], it)
    total, terms, grads = loss_pair["tfn"](it)
    np.testing.assert_allclose(total, float(jtotal), rtol=RTOL)
    assert sorted(terms) == sorted(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(terms[k], float(v), rtol=RTOL, atol=1e-7, err_msg=k)
    for got, want in zip(grads, jgrads):
        # a texel whose three scales are all under the threshold sits at the
        # origin of the norm: JAX differentiates that to NaN, which its train
        # step sets to 0; the port's norm has the zero subgradient there
        _grad_close(got, np.nan_to_num(np.asarray(want), nan=0.0))


def test_optimization_loss_thresholds_change_the_value(loss_pair):
    t0, terms0, _ = loss_pair["tfn"](0)
    t1, terms1, _ = loss_pair["tfn"](1000)
    t2, terms2, _ = loss_pair["tfn"](10001)
    assert terms0["image_loss"] != terms1["image_loss"]            # masking ended
    assert terms2["perpetual_loss"] == pytest.approx(2 * terms1["perpetual_loss"], rel=1e-5)
    assert terms2["image_loss"] == pytest.approx(terms1["image_loss"], rel=1e-6)
    assert t0 != t1 != t2


def test_optimization_loss_without_boxes_or_raw(loss_pair):
    _, terms, grads = loss_pair["tfn"](0, with_boxes=False, with_raw=False)
    assert "head_loss" not in terms and "hand_loss" not in terms
    assert grads[1] is None and grads[0] is not None
    _, both_terms, _ = loss_pair["tfn"](0, with_boxes=False)
    assert both_terms["image_loss"] > terms["image_loss"]
