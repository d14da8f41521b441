"""One-shot avatar prediction, the "sub-second" path (counterpart of
`guava_renderer_tpu/avatar/inferer.py`).

DINO+DPT encoding of the source image; vertex branch = projection-sampled
features + learned per-vertex base + global token -> MLP decoder; UV branch
= inverse texture mapping of [rgb | f_map1] into the UV chart (visibility
masked) -> StyleUNet -> conv decoder with local_pos.

The module takes the EHM geometry (deformed source-pose vertices) and the
static UV tables as call arguments; `build_avatar` orchestrates EHM, mesh
visibility (kernel K5), the network and the avatar's assembly. Tensors that
cross the module's surface keep the JAX layouts (images NHWC, Gaussian
fields (B, N, C)); inside, feature maps are NCHW.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..bodymodel.ehm import BodyParams, EhmModel, FlameParams, ehm_forward
from ..core.cameras import Camera
from ..models.decoders import UVPointGSDecoder, VertexGSDecoder
from ..models.dpt_encoder import DinoDPTEncoder
from ..models.layers import harmonic_embedding, leaky_relu, resize_bilinear
from ..models.styleunet import StyleUNet
from ..ops.meshraster import rasterize_mesh, visible_faces_mask
from .sampling import grid_sample, project_to_ndc
from .state import GaussianAvatar


class InfererConfig(NamedTuple):
    """The MODEL widths (configs/train/ubody_512.yaml)."""

    image_size: int = 512
    uvmap_size: int = 512
    invtanfov: float = 24.0
    dino_out_dim: int = 32
    uv_out_dim: int = 96
    smplx_fea_dim: int = 128
    prj_out_dim: int = 128
    global_vertex_dim: int = 256
    color_dim: int = 32
    uv_base_dim: int = 32
    style_dim: int = 512
    num_mlp: int = 8
    channel_scale: float = 1.0
    # Backbone sizing (ViT-B/14 + DPT defaults; shrink for small configs).
    vit_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    pyramid_dims: tuple = (256, 512, 1024, 1024)


def _mlp3(module: nn.Module, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Linear -> leaky(0.01) -> Linear -> leaky(0.01) -> Linear."""
    for i in range(3):
        x = getattr(module, f"{prefix}{i}")(x)
        if i < 2:
            x = leaky_relu(x, 0.01)
    return x


class UbodyGaussianInferer(nn.Module):
    """`forward` = `encode` -> `vertex_branch` + `uv_branch`; the three are
    separate methods so a caller can time them."""

    def __init__(self, cfg: InfererConfig, num_vertices: int):
        super().__init__()
        self.cfg = cfg
        self.num_vertices = num_vertices
        self.dino_encoder = DinoDPTEncoder(
            out_dim_1=cfg.dino_out_dim, out_dim_2=cfg.prj_out_dim, hidden=cfg.prj_out_dim // 2,
            output_size=cfg.image_size, vit_dim=cfg.vit_dim, vit_depth=cfg.vit_depth,
            vit_heads=cfg.vit_heads, pyramid_dims=cfg.pyramid_dims)
        for i in range(3):
            self.add_module(f"global_map{i}", nn.Linear(
                cfg.vit_dim if i == 0 else cfg.global_vertex_dim, cfg.global_vertex_dim))
            self.add_module(f"uv_style_map{i}", nn.Linear(
                cfg.vit_dim if i == 0 else cfg.style_dim, cfg.style_dim))
        self.vertex_base_feature = nn.Parameter(torch.empty(num_vertices, cfg.smplx_fea_dim))
        self.vertex_gs_decoder = VertexGSDecoder(
            in_dim=cfg.prj_out_dim + cfg.smplx_fea_dim + cfg.global_vertex_dim,
            color_dim=cfg.color_dim)
        self.uv_feature_decoder = StyleUNet(
            cfg.uvmap_size, cfg.dino_out_dim + 3, cfg.uv_out_dim, cfg.style_dim, cfg.num_mlp,
            cfg.channel_scale, small=False, activation=False, extra_style_dim=cfg.style_dim)
        # held channels-first; the flax leaf is (U, U, C)
        self.uv_base_feature = nn.Parameter(
            torch.empty(cfg.uv_base_dim, cfg.uvmap_size, cfg.uvmap_size))
        self.uv_point_decoder = UVPointGSDecoder(
            in_dim=cfg.uv_out_dim + cfg.uv_base_dim, color_dim=cfg.color_dim)

    def encode(self, image: torch.Tensor) -> dict[str, torch.Tensor]:
        """image (B, Hf, Wf, 3) in [0, 1] -> f_map1, f_map2 (NCHW), f_global."""
        return self.dino_encoder(image.permute(0, 3, 1, 2))

    def vertex_branch(self, feats: dict, w2c: torch.Tensor, vertices: torch.Tensor,
                      cam_dirs: torch.Tensor) -> dict:
        cfg = self.cfg
        B = vertices.shape[0]
        g = _mlp3(self, "global_map", feats["f_global"])
        ndc = project_to_ndc(vertices, w2c, cfg.invtanfov)
        vtx_sample = grid_sample(feats["f_map2"].permute(0, 2, 3, 1), ndc[..., :2],
                                 padding="border")                          # (B, V, prj)
        vtx_feat = torch.cat([
            vtx_sample,
            self.vertex_base_feature[None].expand(B, -1, -1),
            g[:, None].expand(-1, self.num_vertices, -1),
        ], dim=-1)
        return self.vertex_gs_decoder(vtx_feat, cam_dirs)

    def uv_branch(self, image: torch.Tensor, feats: dict, w2c: torch.Tensor,
                  vertices: torch.Tensor, uv_texel_mask: torch.Tensor,
                  uvmap_f_idx: torch.Tensor, uvmap_f_bary: torch.Tensor, faces: torch.Tensor,
                  cam_dirs: torch.Tensor) -> tuple[dict, dict]:
        cfg = self.cfg
        B, U = image.shape[0], cfg.uvmap_size
        img_rgb = resize_bilinear(image.permute(0, 3, 1, 2), (cfg.image_size, cfg.image_size))
        img_feat = torch.cat([img_rgb, feats["f_map1"]], dim=1).permute(0, 2, 3, 1)

        # inverse texture mapping: texel -> surface point -> image sample.
        # Empty texels hold face -1, which indexes the last face; the texel
        # mask zeroes what they sample.
        tri = faces.long()[uvmap_f_idx.long()]                  # (U, U, 3)
        tri_pts = vertices[:, tri]                              # (B, U, U, 3, 3)
        surf = torch.einsum("uvk,buvkj->buvj", uvmap_f_bary, tri_pts)
        surf_ndc = project_to_ndc(surf, w2c, cfg.invtanfov)
        uv_feats = grid_sample(img_feat, surf_ndc[..., :2], padding="zeros")
        uv_feats = (uv_feats * uv_texel_mask[..., None]).permute(0, 3, 1, 2)

        extra_style = _mlp3(self, "uv_style_map", feats["f_global"])
        uv_feats = self.uv_feature_decoder(uv_feats, extra_style)           # (B, uv_out, U, U)
        uv_full = torch.cat([uv_feats, self.uv_base_feature[None].expand(B, -1, -1, -1)], dim=1)
        uv_gs = self.uv_point_decoder(uv_full, cam_dirs)                    # NHWC maps
        # flatten the chart; static shapes (masking instead of pruning)
        uv_gs = {k: v.reshape(B, U * U, -1) for k, v in uv_gs.items()}
        extra = {"uvmap_texture": torch.sigmoid(uv_feats[:, :3].permute(0, 2, 3, 1))}
        return uv_gs, extra

    def forward(
        self,
        image: torch.Tensor,          # (B, Hf, Wf, 3) in [0, 1] (518 for GUAVA)
        w2c: torch.Tensor,            # (B, 4, 4)
        vertices: torch.Tensor,       # (B, V, 3) EHM-deformed source-pose verts
        uv_texel_mask: torch.Tensor,  # (B, U, U) f32: chart mask x visibility
        uvmap_f_idx: torch.Tensor,    # (U, U) int, -1 = empty texel
        uvmap_f_bary: torch.Tensor,   # (U, U, 3)
        faces: torch.Tensor,          # (F, 3) int
    ) -> tuple[dict, dict, dict]:
        feats = self.encode(image)
        cam_dirs = harmonic_embedding(w2c[:, :3, 2], 4)        # (B, 27)
        vertex_gs = self.vertex_branch(feats, w2c, vertices, cam_dirs)
        uv_gs, extra = self.uv_branch(image, feats, w2c, vertices, uv_texel_mask,
                                      uvmap_f_idx, uvmap_f_bary, faces, cam_dirs)
        return vertex_gs, uv_gs, extra


def texel_visibility(verts: torch.Tensor, faces: torch.Tensor, w2c: torch.Tensor,
                     uvmap_f_idx: torch.Tensor, uvmap_mask: torch.Tensor,
                     image_size: int, invtanfov: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-item mesh z-buffer -> (texel mask (B, U, U) f32 = chart mask x
    visibility of the texel's face, visible faces (B, F) bool)."""
    vis = []
    for b in range(verts.shape[0]):
        cam = Camera.from_w2c(w2c[b], 1.0 / invtanfov, image_size, image_size)
        mres = rasterize_mesh(verts[b].detach(), faces, cam)
        vis.append(visible_faces_mask(mres.face_idx, faces.shape[0]))
    visible = torch.stack(vis)                                  # (B, F)
    texel_vis = visible[:, uvmap_f_idx.long()]                  # (B, U, U); -1 -> last face
    return (texel_vis & uvmap_mask.bool()[None]).float(), visible


def assemble_avatar(vertex_gs: dict, uv_gs: dict, v_template: torch.Tensor,
                    uvmap_f_idx: torch.Tensor, uvmap_f_bary: torch.Tensor,
                    uvmap_mask: torch.Tensor) -> GaussianAvatar:
    """Network outputs -> avatar state (sigmoid on the first 3 colour channels)."""
    def sig3(c):
        return torch.cat([torch.sigmoid(c[..., :3]), c[..., 3:]], dim=-1)

    B = vertex_gs["colors"].shape[0]
    return GaussianAvatar(
        vtx_positions=v_template[None].expand(B, -1, -1),
        vtx_colors=sig3(vertex_gs["colors"]),
        vtx_opacity=vertex_gs["opacities"],
        vtx_scales=vertex_gs["scales"],
        vtx_rotations=vertex_gs["rotations"],
        uv_local_xyz=uv_gs["local_pos"],
        uv_colors=sig3(uv_gs["colors"]),
        uv_opacity=uv_gs["opacities"],
        uv_scales=uv_gs["scales"],
        uv_rotations=uv_gs["rotations"],
        uv_binding_face=uvmap_f_idx.reshape(-1).long(),
        uv_face_bary=uvmap_f_bary.reshape(-1, 3),
        uv_valid=uvmap_mask.reshape(-1).bool(),
    )


def build_avatar(
    inferer: UbodyGaussianInferer,
    ehm: EhmModel,
    faces: torch.Tensor,
    uvmap_f_idx: torch.Tensor,
    uvmap_f_bary: torch.Tensor,
    uvmap_mask: torch.Tensor,
    image: torch.Tensor,
    w2c: torch.Tensor,
    body: BodyParams,
    flame: FlameParams | None,
    image_size: int = 512,
    invtanfov: float = 24.0,
) -> tuple[GaussianAvatar, dict]:
    """EHM -> visibility -> network -> GaussianAvatar. The inferer holds
    its own weights; everything lies on the inferer's device."""
    res = ehm_forward(ehm, body, flame)
    verts = res.vertices
    texel_mask, visible = texel_visibility(verts, faces, w2c, uvmap_f_idx, uvmap_mask,
                                           image_size, invtanfov)
    vertex_gs, uv_gs, extra = inferer(image, w2c, verts, texel_mask, uvmap_f_idx,
                                      uvmap_f_bary, faces)
    avatar = assemble_avatar(vertex_gs, uv_gs, ehm.smplx["v_template"], uvmap_f_idx,
                             uvmap_f_bary, uvmap_mask)
    extra["ehm_result"] = res
    extra["visible_faces"] = visible
    extra["texel_mask"] = texel_mask
    return avatar, extra
