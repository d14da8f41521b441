"""The 512^2 benchmark scene (counterpart of `guava_renderer_tpu/benchscene.py`).

Full-scale synthetic rig (SMPL-X-scale vertex count + 512^2 UV chart) with
trained-avatar splat statistics: mostly sub-tile splats with a fat tail of
multi-tile ones. The numpy RNG draws follow the JAX scene's order, so both
packages build the same splats from the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .avatar.deformer import deform_avatar
from .avatar.state import GaussianAvatar, GaussianSet, prune_avatar
from .bodymodel.ehm import BodyParams, EhmModel, FlameParams
from .bodymodel.synthetic import synthetic_ehm
from .core.cameras import Camera
from .device import resolve_device

INVTANFOV = 24.0

# Size-class ladders ((count, cap), ...) of the JAX package, for
# `RasterizeSettings.size_classes`: descending tile-rect-area classes. The
# port bins uncapped, so here they only choose the Gaussians that
# `vmem_classes` keeps resident. EXACT_LADDER is
# guava_renderer_tpu/benchscene.py:43; UBODY_LADDER is the raster block of
# configs/train/ubody_512.yaml:55-56, whose first two classes hold
# 173 + 892 = 1,065 Gaussians.
EXACT_LADDER = ((256, 256), (3840, 64), (28672, 16), (32768, 4))
UBODY_LADDER = ((173, 256), (892, 100), (1528, 49), (2868, 30), (3858, 16), (11177, 9),
                (128417, 4))


class BenchScene(NamedTuple):
    avatar: GaussianAvatar    # pruned (threshold 0), trained-stats splats
    ehm: EhmModel
    smplx: object             # ParametricModelData
    extras: object            # SmplxExtras
    faces: torch.Tensor       # (F, 3) int64
    cam: Camera               # the bench viewpoint
    w2c: np.ndarray           # (4, 4) f32 world-to-camera of `cam`
    base_body: BodyParams     # frame-0 pose
    base_flame: FlameParams
    size: int
    uv: int


class CreateScene(NamedTuple):
    """The inputs of one avatar creation on the bench rig."""
    ehm: EhmModel
    smplx: object             # ParametricModelData
    extras: object            # SmplxExtras
    faces: torch.Tensor       # (F, 3) int64
    uv_tables: tuple          # (uvmap_f_idx (U, U) i64, uvmap_f_bary (U, U, 3), uvmap_mask (U, U) bool)
    source: dict              # {"image": (Hf, Wf, 3) f32 numpy, "w2c": (4, 4), "params": zero pose}
    size: int
    uv: int


class TrainScene(NamedTuple):
    """The inputs of a training step on the bench rig."""
    ehm: EhmModel
    smplx: object             # ParametricModelData
    extras: object            # SmplxExtras
    faces: torch.Tensor       # (F, 3) int64
    uv_tables: tuple          # as CreateScene's
    batch: dict               # the training batch (train/pipeline.py), tensors on the device
    size: int
    uv: int


def _rig(uv: int, body_side: int, head_side: int):
    return synthetic_ehm(body_side=body_side, head_side=head_side, uv_size=uv,
                         n_shape=50, n_exp=20)


def make_create_scene(size: int = 512, uv: int = 512, body_side: int = 101,
                      head_side: int = 15, feat_size: int = 518, device="cuda") -> CreateScene:
    """The JAX bench's creation inputs: the bench rig, a seeded uniform
    feat_size^2 source image, the camera at z = 30, zero pose."""
    dev = resolve_device(device)
    smplx, flame_m, extras = _rig(uv, body_side, head_side)
    ehm = EhmModel.build(smplx, flame_m, extras, device=dev)
    image = np.random.default_rng(0).uniform(0, 1, (1, feat_size, feat_size, 3))
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 30.0
    params = {
        "shape": np.zeros(smplx.n_shape, np.float32),
        "body_pose": np.zeros((21, 3), np.float32),
        "flame_shape": np.zeros(smplx.n_shape, np.float32),
        "flame_exp": np.zeros(smplx.n_exp, np.float32),
        "flame_jaw": np.zeros(3, np.float32),
    }
    uv_tables = (
        torch.as_tensor(np.asarray(extras.uvmap_f_idx), dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(extras.uvmap_f_bary), dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(extras.uvmap_mask), dtype=torch.bool, device=dev),
    )
    return CreateScene(
        ehm, smplx, extras, torch.as_tensor(smplx.faces, dtype=torch.int64, device=dev),
        uv_tables, {"image": image[0].astype(np.float32), "w2c": w2c, "params": params},
        size, uv)


def make_train_scene(size: int = 512, uv: int = 512, body_side: int = 101,
                     head_side: int = 15, feat_size: int = 518, batch_size: int = 1,
                     seed: int = 0, device="cuda") -> TrainScene:
    """A training batch on the bench rig: seeded uniform feat_size^2 source
    and size^2 target images with an all-ones mask, the camera at z = 30
    for both, small random source and target poses, and the head and hand
    crop boxes of the small test pipelines scaled to `size`."""
    from .testing import synthetic_batch, tree_to_torch   # testing imports this module's peers

    dev = resolve_device(device)
    create = make_create_scene(size, uv, body_side, head_side, feat_size, device=dev)
    batch = synthetic_batch(np.random.default_rng(seed), batch_size, size, feat_size,
                            create.smplx.n_shape, create.smplx.n_exp, z=30.0)
    return TrainScene(create.ehm, create.smplx, create.extras, create.faces, create.uv_tables,
                      tree_to_torch(batch, dev), size, uv)


def make_bench_scene(size: int = 512, uv: int = 512, body_side: int = 101,
                     head_side: int = 15, device="cuda") -> BenchScene:
    dev = resolve_device(device)
    smplx, flame_m, extras = _rig(uv, body_side, head_side)
    ehm = EhmModel.build(smplx, flame_m, extras, device=dev)
    V = smplx.num_vertices
    N_uv = uv * uv
    rng = np.random.default_rng(0)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def mk(shape, lo, hi):
        return t(rng.uniform(lo, hi, shape).astype(np.float32))

    def trained_stats_scales(n, base):
        u = rng.uniform(0, 1, n)
        s = np.where(
            u < 0.85, rng.lognormal(-4.2, 0.3, n),
            np.where(u < 0.95, rng.lognormal(-3.0, 0.3, n), rng.lognormal(-1.9, 0.4, n)),
        ) * base
        aniso = rng.lognormal(0, 0.2, (n, 2))
        return t(np.stack([s, s * aniso[:, 0], s * aniso[:, 1]], -1).astype(np.float32))[None]

    def trained_stats_opacity(n):
        return t((1.0 / (1.0 + np.exp(-rng.normal(-1.0, 1.5, (1, n, 1))))).astype(np.float32))

    quats = rng.normal(size=(1, V, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    uv_quats = rng.normal(size=(1, N_uv, 4)).astype(np.float32)
    uv_quats /= np.linalg.norm(uv_quats, axis=-1, keepdims=True)

    # keyword order = the JAX scene's draw order
    avatar = GaussianAvatar(
        vtx_positions=t(smplx.v_template)[None],
        vtx_colors=mk((1, V, 32), 0, 1),
        vtx_opacity=trained_stats_opacity(V),
        vtx_scales=trained_stats_scales(V, 0.7),
        vtx_rotations=t(quats),
        uv_local_xyz=mk((1, N_uv, 3), -0.5, 0.5),
        uv_colors=mk((1, N_uv, 32), 0, 1),
        uv_opacity=trained_stats_opacity(N_uv),
        uv_scales=trained_stats_scales(N_uv, 40.0),
        uv_rotations=t(uv_quats),
        uv_binding_face=t(extras.uvmap_f_idx.reshape(-1), torch.int64),
        uv_face_bary=t(extras.uvmap_f_bary.reshape(-1, 3)),
        uv_valid=t(extras.uvmap_mask.reshape(-1), torch.bool),
    )
    # threshold 0 drops only the statically dead chart rows (uv_valid False)
    avatar = prune_avatar(avatar, opacity_threshold=0.0)

    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 30.0  # long lens (invtanfov 24) needs distance
    cam = Camera.from_w2c(t(w2c), 1.0 / INVTANFOV, size, size)
    base_body = BodyParams(shape=torch.zeros((1, smplx.n_shape), device=dev),
                           body_pose=torch.zeros((1, 21, 3), device=dev))
    base_flame = FlameParams(shape=torch.zeros((1, smplx.n_shape), device=dev),
                             exp=torch.zeros((1, smplx.n_exp), device=dev),
                             jaw=torch.zeros((1, 3), device=dev))
    return BenchScene(avatar, ehm, smplx, extras, t(smplx.faces, torch.int64), cam, w2c,
                      base_body, base_flame, size, uv)


def frame0_gaussians(sc: BenchScene) -> GaussianSet:
    """The deformed frame-0 (base pose) Gaussian set, by the row-gather path."""
    with torch.no_grad():
        return deform_avatar(sc.avatar, sc.ehm, sc.faces, sc.base_body, sc.base_flame)
