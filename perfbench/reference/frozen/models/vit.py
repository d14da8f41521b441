"""DINOv2-style Vision Transformer (counterpart of
`guava_renderer_tpu/models/vit.py`): 14x14 patch embed, CLS token,
interpolated position embeddings, pre-LN blocks with LayerScale, exact-erf
GELU MLP; `forward` returns the last `num_intermediate` block outputs, each
through the shared final norm.

Submodules carry the flax names (`patch_embed`, `block{i}.attn.qkv`,
`mlp.Dense_0`, `ls1.gamma`, ...), so convert.py maps a flax tree leaf by
leaf. Attention is plain matmul + softmax in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import resize_bilinear


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        d = D // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))   # (B, H, N, d)
        attn = torch.softmax((q * d ** -0.5) @ k.transpose(-2, -1), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, D))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class VisionTransformer(nn.Module):
    """ViT-B/14 defaults. images (B, 3, H, W), H and W multiples of the
    patch size -> list of `num_intermediate` token tensors (B, 1 + N, D),
    CLS first."""

    def __init__(self, patch_size=14, dim=768, depth=12, num_heads=12, pos_grid=37,
                 num_intermediate=5):
        super().__init__()
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.pos_grid, self.num_intermediate = pos_grid, num_intermediate
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, num_heads))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        B, _, H, W = images.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = self.patch_embed(images).flatten(2).transpose(1, 2)      # (B, gh*gw, D)
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (self.pos_grid, self.pos_grid):
            grid = pos_patch.reshape(1, self.pos_grid, self.pos_grid, self.dim)
            grid = resize_bilinear(grid.permute(0, 3, 1, 2), (gh, gw))
            pos_patch = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, self.dim)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + torch.cat([pos_cls, pos_patch], dim=1)
        outs = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
            if i >= self.depth - self.num_intermediate:
                outs.append(x)
        return [self.norm(o) for o in outs]
