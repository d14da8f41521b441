"""The renderer's refiner options against the JAX package
(`guava_renderer_tpu/avatar/renderer.py`, `models/styleunet.py:SimpleUNet`):
SimpleUNet and the `simpleunet` refiner (under a sigmoid), StyleUNet with
`small=False`, and `refiner_size` (features resized to the refiner's size
and the RGB back), in float32 within atol 1e-4; and the bf16 refiner
against the JAX bf16 refiner.

bf16 tolerance: both packages round every layer's output to bf16 (8
significant bits, an ulp of 2^-8 at 1.0), but in different places inside a
layer (XLA's CPU bf16 convolutions and PyTorch's accumulate and round
differently), and the differences compound through the ~20 layers of a
refiner. Measured on this file's inputs (sigmoid outputs in [0, 1]): port
against JAX at most 0.0078, mean 0.0011 (StyleUNet-small) and at most
0.0039 (one bf16 ulp at 1.0), mean 0.0010 (SimpleUNet); each package
within 0.0062 of its own float32 refiner. BF16_ATOL = 0.03 and BF16_MEAN
= 0.004 are about four times the largest of each (at 16^2, two levels
deeper, the largest read 0.0117, mean 0.0017).

At full width (StyleUNet-small 512, style 512, 8 mapping layers: the
widths of configs/train/ubody_512.yaml) with random flax-scale weights the
refiner saturates (logits of median magnitude ~10), and a pixel near the
sigmoid's edge may flip under bf16, so the largest difference says little
(0.209 on the CPU, 0.914 on an H100). On uniform [0, 1] features (seed 3)
the port's bf16 refiner reads on average 0.0057 from its float32 refiner
on the CPU, and 6.3% of its outputs lie over BF16_ATOL from it (no JAX
counterpart at this width: its CPU compile would take minutes).
FULL_BF16_MEAN = 0.012 and FULL_BF16_SHARE = 0.13 are twice those;
chip_smoke.py phase 13 holds the card's full-width bf16 refiner to them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu.avatar.renderer import NeuralRefiner as JRefiner
from guava_renderer_tpu.models.layers import resize_bilinear as jresize
from guava_renderer_tpu.models.styleunet import SimpleUNet as JSimpleUNet
from guava_renderer_tpu_torch.avatar.renderer import GaussianRenderer
from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner as TRefiner
from guava_renderer_tpu_torch.convert import state_dict_from_flax
from guava_renderer_tpu_torch.models.styleunet import SimpleUNet

torch.set_num_threads(2)
ATOL = 1e-4
BF16_ATOL = 0.03
BF16_MEAN = 4e-3
FULL_BF16_MEAN = 0.012
FULL_BF16_SHARE = 0.13
SIZE = 8
NARROW = dict(style_dim=16, num_mlp=1, channel_scale=16.0)


def _input(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _params(module, x_shape, seed):
    """A flax parameter tree for `module`, its leaves drawn with numpy at the
    flax initializers' scales (the tree from `jax.eval_shape`, which
    compiles nothing): kernels N(0, 1/fan_in), biases N(0, 0.1^2),
    modulation biases 1 + N(0, 0.1^2), the constant input N(0, 1), noise
    weights 0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(x_shape))

    def leaf(path, sd):
        names = [getattr(k, "key", "") for k in path]
        name, shape = names[-1], sd.shape
        if name == "noise_weight":
            a = np.zeros(shape)
        elif name == "constant_input":
            a = rng.normal(size=shape)
        elif name == "bias":
            a = rng.normal(0, 0.1, shape) + (1.0 if "modulation" in names else 0.0)
        else:
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("in_size", [SIZE, 2 * SIZE], ids=["in=out", "in>out (first_down)"])
def test_simpleunet_vs_jax(in_size):
    """At its in_size, and (in=out) on a smaller input, which it upsamples."""
    jm = JSimpleUNet(in_size=in_size, out_size=SIZE, in_dim=32, out_dim=3, channel_scale=16)
    params = _params(jm, (1, in_size, in_size, 32), seed=in_size)
    tm = SimpleUNet(in_size, SIZE, 32, 3, 16.0)
    tm.load_state_dict(state_dict_from_flax(params))
    for x_size in (in_size, SIZE // 2) if in_size == SIZE else (in_size,):
        x = _input((2, x_size, x_size, 32), seed=x_size)
        want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, SIZE, SIZE, 3)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _refiners(refiner_type, small, seed):
    """(JAX refiner, its f32 params, the port's refiner carrying them)."""
    jm = JRefiner(refiner_type=refiner_type, image_size=SIZE, small=small, **NARROW)
    params = _params(jm, (1, SIZE, SIZE, 32), seed)
    tm = TRefiner(SIZE, small=small, refiner_type=refiner_type, **NARROW)
    tm.load_state_dict(state_dict_from_flax(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def refiners():
    return {key: _refiners(*key, seed=i) for i, key in
            enumerate((("simpleunet", True), ("styleunet", False), ("styleunet", True)))}


@pytest.mark.parametrize("key", [("simpleunet", True), ("styleunet", False)],
                         ids=["simpleunet", "styleunet small=False"])
def test_refiner_option_vs_jax(refiners, key):
    jm, params, tm = refiners[key]
    x = _input((2, SIZE, SIZE, 32), seed=1)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if key[0] == "simpleunet":                      # under a sigmoid
        assert 0.0 < got.min() and got.max() < 1.0


def test_refiner_size_vs_jax(refiners):
    """Raster at 12^2, refine at 8^2: the JAX renderer's tail
    (avatar/renderer.py:150-163), resize -> refine -> resize back."""
    jm, params, tm = refiners[("styleunet", True)]
    big = SIZE * 3 // 2
    x = _input((1, big, big, 32), seed=2)

    @jax.jit
    def jtail(p, f):
        r = jm.apply(p, jresize(f, (SIZE, SIZE))).astype(jnp.float32)
        return jresize(r, (big, big))

    want = np.asarray(jtail(params, jnp.asarray(x)))
    with torch.no_grad():
        got = GaussianRenderer(tm, refiner_size=SIZE).refine(torch.tensor(x)).numpy()
    assert got.shape == (1, big, big, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    with torch.no_grad():    # no refiner_size: the refiner runs at the raster size
        same = GaussianRenderer(tm).refine(torch.tensor(x[:, :SIZE, :SIZE])).numpy()
        np.testing.assert_array_equal(same, tm(torch.tensor(x[:, :SIZE, :SIZE])).numpy())


@pytest.mark.parametrize("key", [("styleunet", True), ("simpleunet", True)],
                         ids=["styleunet small", "simpleunet"])
def test_bf16_refiner_vs_jax(refiners, key):
    """JAX: bf16 parameters (cli/inference.py:85-93) and a bf16 input, the
    output cast to float32. Port: the refiner cast to bf16 by the caller,
    `refiner_dtype` casting the input and the output."""
    jm, params, tm = refiners[key]
    x = _input((1, SIZE, SIZE, 32), seed=4)
    pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    want = np.asarray(jax.jit(jm.apply)(pb, jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    r = GaussianRenderer(TRefiner(SIZE, small=key[1], refiner_type=key[0], **NARROW),
                         refiner_dtype=torch.bfloat16)
    r.neural_refiner.load_state_dict(tm.state_dict())
    r.neural_refiner.to(torch.bfloat16)
    with torch.no_grad():
        got = r.refine(torch.tensor(x))
        f32 = tm(torch.tensor(x)).numpy()
    assert got.dtype == torch.float32
    got = got.numpy()
    diff = np.abs(got - want)
    assert diff.max() <= BF16_ATOL and diff.mean() <= BF16_MEAN, (diff.max(), diff.mean())
    # it is a bf16 computation: not the float32 refiner's result
    assert np.abs(got - f32).max() > 1e-4


def test_bf16_stays_bf16_through_the_refiner(refiners):
    """No layer promotes back to float32 (the trap of cli/inference.py:86-87):
    every activation of the bf16 refiner is bf16."""
    _, _, tm = refiners[("styleunet", True)]
    ref = TRefiner(SIZE, small=True, **NARROW)
    ref.load_state_dict(tm.state_dict())
    ref.to(torch.bfloat16)
    dtypes = set()
    hooks = [m.register_forward_hook(lambda m, i, o: dtypes.add(o.dtype))
             for m in ref.modules()]
    with torch.no_grad():
        ref(torch.tensor(_input((1, SIZE, SIZE, 32))).to(torch.bfloat16))
    for h in hooks:
        h.remove()
    assert dtypes == {torch.bfloat16}


def test_bf16_refiner_full_width():
    """The port's bf16 refiner against its float32 refiner at the widths of
    configs/train/ubody_512.yaml (random weights, seed 0)."""
    from guava_renderer_tpu_torch.models.styleunet import init_params_

    ref = init_params_(TRefiner(512), torch.Generator().manual_seed(0))
    x = torch.rand((1, 512, 512, 32), generator=torch.Generator().manual_seed(3))
    bf16 = TRefiner(512)
    bf16.load_state_dict(ref.state_dict())
    with torch.no_grad():
        f32 = GaussianRenderer(ref).refine(x)
        got = GaussianRenderer(bf16.to(torch.bfloat16), refiner_dtype=torch.bfloat16).refine(x)
    diff = (got - f32).abs()
    share = float((diff > BF16_ATOL).float().mean())
    assert float(diff.mean()) <= FULL_BF16_MEAN and share <= FULL_BF16_SHARE, \
        (float(diff.mean()), share)
    assert float(diff.mean()) > 1e-4      # a bf16 computation, not the float32 one


def test_unknown_refiner_type_raises():
    with pytest.raises(ValueError, match="unknown refiner_type"):
        TRefiner(SIZE, refiner_type="unet3")
