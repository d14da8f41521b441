"""The port's weight converters (`guava_renderer_tpu_torch/train/weights.py`,
`train/lpips.py:lpips_state_dict`) against the JAX route.

Torch minis with the reference's module names stand in for the released
files (as tests/test_guava_convert.py and tests/test_weight_convert.py
build them): a GUAVA checkpoint at the widths of micro_synthetic.yaml, a
DINOv2 ViT and an LPIPS-alex. Each is converted by the JAX converter
followed by `convert.state_dict_from_flax` and by the port's own converter;
the two state dicts must be bit-equal and load strictly into the port's
modules. The two `python -m` tools run on files the test writes.
"""

import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from guava_renderer_tpu.train import weights as jweights
from guava_renderer_tpu.train.lpips import LPIPS as JLPIPS
from guava_renderer_tpu.train.lpips import load_torch_state as jload_torch_state
from guava_renderer_tpu_torch.cli import context as tctx
from guava_renderer_tpu_torch.convert import model_state_dict_from_flax, state_dict_from_flax
from guava_renderer_tpu_torch.models.vit import VisionTransformer
from guava_renderer_tpu_torch.tools import convert_guava_checkpoint, convert_weights
from guava_renderer_tpu_torch.train import weights as tweights
from guava_renderer_tpu_torch.train.lpips import LPIPS, load_torch_state, lpips_state_dict
from guava_renderer_tpu_torch.utils.config import load_config

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_guava_convert import TDPT, TMiniDino, TStyleUNet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MICRO = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
torch.manual_seed(0)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _seq(*dims, act=nn.LeakyReLU(0.2)):
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        layers += [nn.Linear(a, b)] + ([act] if i < len(dims) - 2 else [])
    return nn.Sequential(*layers)


def _conv_seq(*specs):
    """[(cin, cout, k), ...] with an activation between convs (indices 0, 2, 4)."""
    layers = []
    for i, (a, b, k) in enumerate(specs):
        layers += [nn.Conv2d(a, b, k, padding=k // 2)] + \
            ([nn.LeakyReLU(0.01)] if i < len(specs) - 1 else [])
    return nn.Sequential(*layers)


class TGuavaInferer(nn.Module):
    """Ubody_Gaussian_inferer's parameters under the reference's names
    (ref: ubody_gaussian.py:20-159, feature_decoder.py) at micro widths."""

    def __init__(self, m, V):
        super().__init__()
        prj, fea, gvd, style = m.prj_out_dim, m.smplx_fea_dim, m.global_vertex_dim, \
            m.styleunet.num_style_feat
        vit, cs, U = m.vit_dim, m.styleunet.channel_scale, m.uvmap_size
        self.dino_encoder = TDPT(vit, m.vit_depth, m.vit_heads, 37, m.dino_out_dim, prj,
                                 prj // 2, tuple(m.pyramid_dims))
        self.global_feature_mapping = _seq(vit, gvd, gvd, gvd)
        self.uv_style_mapping = _seq(vit, style, style, style)
        self.vertex_base_feature = nn.Parameter(torch.randn(V, fea))
        self.uv_base_feature = nn.Parameter(torch.randn(m.uv_base_dim, U, U))
        vin, dirs, color = prj + fea + gvd, 27, m.color_dim
        self.vertex_gs_decoder = nn.Module()
        self.vertex_gs_decoder.feature_layers = _seq(vin, vin // 2, vin // 2, vin // 2,
                                                     vin // 2, act=nn.ReLU())
        for name, od in (("color_layers", color), ("opacity_layers", 1), ("scale_layers", 3),
                         ("rotation_layers", 4)):
            setattr(self.vertex_gs_decoder, name, _seq(vin // 2 + dirs, 128, od, act=nn.ReLU()))
        uin = m.uv_out_dim + m.uv_base_dim
        h1, h2 = max(uin, 128), max(uin // 2, 64)
        d = self.uv_point_decoder = nn.Module()
        d.feature_conv = _conv_seq((uin + dirs, h1, 3), (h1, h1, 3), (h1, h1, 3))
        d.rot_head = _conv_seq((h1, h2, 3), (h2, 4, 1))
        d.scale_head = _conv_seq((h1, h2, 3), (h2, 3, 1))
        d.opacity_head = _conv_seq((h1, h2, 3), (h2, 1, 1))
        d.color_head = _conv_seq((h1, h1, 3), (h1, color, 1))
        d.local_pos_head = _conv_seq((h1, h1, 3), (h1, h2, 3), (h2, 3, 1))
        self.uv_feature_decoder = TStyleUNet(U, U, m.dino_out_dim + 3, m.uv_out_dim, style,
                                             m.styleunet.num_mlp, cs=cs, small=False,
                                             extra_style_dim=style)


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def guava():
    cfg = load_config(MICRO)
    m = cfg.MODEL
    rt = tctx.build_runtime(cfg, synthetic_assets=True, device="cpu")
    model_sd = _numpy_sd(TGuavaInferer(m, rt.num_vertices))
    st = m.styleunet
    refiner = nn.Module()
    refiner.nerual_refiner = TStyleUNet(m.image_size, m.image_size, 32, 3, st.num_style_feat,
                                        st.num_mlp, cs=st.channel_scale, small=True)
    render_sd = _numpy_sd(refiner)
    sizes = dict(uvmap_size=m.uvmap_size, image_size=m.image_size, num_mlp=st.num_mlp,
                 channel_scale=float(st.channel_scale))
    return rt, model_sd, render_sd, sizes


def _bit_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_guava_both_routes_bit_equal(guava):
    rt, model_sd, render_sd, sizes = guava
    want = model_state_dict_from_flax(jweights.convert_guava_state(model_sd, render_sd, **sizes))
    got = tweights.guava_state_dict(model_sd, render_sd, **sizes)
    _bit_equal(got, want)
    rt.model.load_state_dict(got)        # strict: every name and shape of the port's modules


def test_convert_guava_checkpoint_tool(guava, tmp_path):
    rt, model_sd, render_sd, sizes = guava
    load_config(MICRO)._dump(str(tmp_path / "config.yaml"))
    ckpt = {"model": {k: torch.from_numpy(v) for k, v in model_sd.items()},
            "render_model": {k: torch.from_numpy(v) for k, v in render_sd.items()},
            "global_iter": 100}
    torch.save(ckpt, tmp_path / "best_100.pt")
    torch.save({"model": {}, "render_model": {}}, tmp_path / "latest.pt")   # not chosen
    jtool = _jax_tool("convert_guava_checkpoint")
    assert convert_guava_checkpoint.find_pt_file(str(tmp_path)) == \
        jtool.find_pt_file(str(tmp_path)) == str(tmp_path / "best_100.pt")
    out = convert_guava_checkpoint.main(["-m", str(tmp_path)])
    assert out == str(tmp_path / "converted_params.pt")
    model, desc = tctx.load_model_params(rt, str(tmp_path))
    assert desc.startswith("converted reference weights")
    want = model_state_dict_from_flax(jweights.convert_guava_state(model_sd, render_sd, **sizes))
    _bit_equal({k: v for k, v in model.state_dict().items()}, want)


def test_dinov2_both_routes_bit_equal(tmp_path):
    dim, depth, heads, grid = 32, 3, 4, 4
    state = {k: v.detach().numpy() for k, v in TMiniDino(dim, depth, heads, grid)
             .state_dict().items()}
    state["mask_token"] = np.zeros((1, dim), np.float32)        # the hub model has one
    want = state_dict_from_flax(_jax_tool("convert_weights").convert_dinov2(state, depth=depth))
    got = tweights.dinov2_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    _bit_equal(got, want)
    VisionTransformer(dim=dim, depth=depth, num_heads=heads, pos_grid=grid).load_state_dict(got)

    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "dino.pth")
    out = convert_weights.main(["--dinov2", str(tmp_path / "dino.pth"),
                                "--out", str(tmp_path / "dinov2_vitb14.pt")])
    _bit_equal(torch.load(out, weights_only=True), want)


class TAlexLPIPS(nn.Module):
    """The lpips package's names: torchvision AlexNet slices and lin heads."""

    def __init__(self):
        super().__init__()
        self.net = nn.Module()
        convs = ((1, 0, 3, 64, 11), (2, 3, 64, 192, 5), (3, 6, 192, 384, 3),
                 (4, 8, 384, 256, 3), (5, 10, 256, 256, 3))
        for sl, idx, cin, cout, k in convs:
            seq = nn.Sequential(*[nn.Identity() for _ in range(idx)],
                                nn.Conv2d(cin, cout, k, padding=k // 2))
            setattr(self.net, f"slice{sl}", seq)
        for i, ch in enumerate((64, 192, 384, 256, 256)):
            lin = nn.Module()
            lin.model = nn.Sequential(nn.Dropout(), nn.Conv2d(ch, 1, 1, bias=False))
            setattr(self, f"lin{i}", lin)


def test_lpips_both_routes_bit_equal(tmp_path):
    state = _numpy_sd(TAlexLPIPS())
    jm = JLPIPS(net_type="alex")
    x = jnp.zeros((1, 64, 64, 3))
    tmpl = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x)
    want = state_dict_from_flax(jload_torch_state(tmpl, state, "alex")["params"])
    got = lpips_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    _bit_equal(got, want)
    lp = load_torch_state(LPIPS("alex"), state)
    _bit_equal({k: v for k, v in lp.state_dict().items()}, want)

    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "alex.pth")
    out = convert_weights.main(["--lpips", str(tmp_path / "alex.pth"),
                                "--out", str(tmp_path / "lpips_alex.pt")])
    _bit_equal(torch.load(out, weights_only=True), want)


def test_lpips_refuses_a_misshapen_state():
    state = _numpy_sd(TAlexLPIPS())
    state["net.slice2.3.weight"] = np.zeros((192, 64, 3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_torch_state(LPIPS("alex"), state)


def test_merge_params():
    template = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.float64)}}
    out = tweights.merge_params(template, {"b": {"c": np.arange(4, dtype=np.float32)}})
    assert out["a"] is template["a"] and out["b"]["c"].dtype == torch.float64
    assert out["b"]["c"].tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="unexpected keys"):
        tweights.merge_params(template, {"z": np.zeros(1)})
    with pytest.raises(ValueError, match="missing keys"):
        tweights.merge_params(template, {"a": np.zeros((2, 3))}, require_all=True)
    with pytest.raises(ValueError, match="shape mismatch at /a"):
        tweights.merge_params(template, {"a": np.zeros((3, 2))})
    assert math.prod(out["a"].shape) == 6
