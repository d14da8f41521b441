"""One-shot avatar creation and per-frame rendering (counterpart of
`guava_renderer_tpu/cli/inference.py:FramePipeline`).

Creation is: EHM forward -> mesh z-buffer visibility (kernel K5) ->
DINO+DPT encoder -> vertex and UV branches -> prune -> face-sort plan.
A frame is: EHM forward -> deform (planned face gather, kernel K2) ->
project -> bin -> tile blend (kernel K1) -> refiner (StyleUNet-small by
default; the renderer's options choose SimpleUNet, another refiner size and
a bf16 refiner).
"""

from __future__ import annotations

import copy

import torch

from ..avatar.deformer import deform_avatar, sort_avatar_by_plan
from ..avatar.inferer import UbodyGaussianInferer, build_avatar
from ..avatar.renderer import GaussianRenderer, NeuralRefiner
from ..avatar.state import GaussianAvatar, prune_avatar
from ..bodymodel.ehm import BodyParams, EhmModel, FlameParams
from ..core.cameras import Camera
from ..device import resolve_device
from ..ops.facegather import build_face_sort_plan, compact_faces
from ..ops.gsplat import RasterizeSettings

# identity/pose keys a target record may carry
_PARAM_KEYS = (
    "shape", "body_pose", "global_pose", "left_hand_pose", "right_hand_pose",
    "exp", "joints_offset", "head_scale", "hand_scale",
    "flame_shape", "flame_exp", "flame_jaw", "flame_eyes", "flame_eyelids",
)


def _batched_params(rec_params: dict, device: torch.device) -> dict:
    """Records are per-frame (unbatched): add the batch dim to every known key."""
    return {
        k: torch.as_tensor(v, dtype=torch.float32, device=device)[None]
        for k, v in rec_params.items() if k in _PARAM_KEYS
    }


def _unpack_params(p: dict) -> tuple[BodyParams, FlameParams]:
    body = BodyParams(
        shape=p["shape"],
        body_pose=p["body_pose"],
        global_pose=p.get("global_pose"),
        left_hand_pose=p.get("left_hand_pose"),
        right_hand_pose=p.get("right_hand_pose"),
        exp=p.get("exp"),
        joints_offset=p.get("joints_offset"),
        head_scale=p.get("head_scale"),
        hand_scale=p.get("hand_scale"),
    )
    flame = FlameParams(
        shape=p["flame_shape"],
        exp=p["flame_exp"],
        jaw=p["flame_jaw"],
        eyes=p.get("flame_eyes"),
        eyelids=p.get("flame_eyelids"),
    )
    return body, flame


class FramePipeline:
    """Create an avatar from one image; deform + rasterize + refine its frames.

    `ehm`, `faces` (F, 3), the refiner and, for creation, the inferer with
    the UV tables `(uvmap_f_idx (U, U), uvmap_f_bary (U, U, 3), uvmap_mask
    (U, U))` live on `device`. Targets are records {"params": {key:
    unbatched array}, "w2c": (4, 4)}; a source record adds "image"
    (Hf, Wf, 3) in [0, 1].

    `refiner_size` and `refiner_dtype` are the renderer's options
    (`avatar/renderer.py:GaussianRenderer`). With `refiner_dtype` the
    pipeline refines with a copy of `refiner` cast to that dtype, where the
    JAX pipeline casts the refiner's parameters (float32 parameters would
    promote a bf16 input back to float32 there, and raise here); the
    caller's refiner stays float32.
    """

    def __init__(self, ehm: EhmModel, faces, refiner: NeuralRefiner, *,
                 inferer: UbodyGaussianInferer | None = None, uv_tables=None,
                 image_size: int = 512, invtanfov: float = 24.0,
                 settings: RasterizeSettings = RasterizeSettings(tile=32),
                 opacity_threshold: float = 0.001, refiner_size: int | None = None,
                 refiner_dtype: torch.dtype | None = None, device="cuda"):
        self.device = resolve_device(device)
        if (inferer is None) != (uv_tables is None):
            raise ValueError("creation needs both the inferer and the UV tables")
        self.ehm = ehm
        self.faces = torch.as_tensor(faces, device=self.device)
        if refiner_dtype is not None:
            refiner = copy.deepcopy(refiner).to(refiner_dtype)
        self.renderer = GaussianRenderer(refiner, settings, refiner_size,
                                         refiner_dtype).to(self.device).eval()
        self.inferer = None if inferer is None else inferer.to(self.device).eval()
        self.uv_tables = None if uv_tables is None else tuple(
            torch.as_tensor(t, device=self.device) for t in uv_tables)
        self.invtanfov = invtanfov
        self.image_size = image_size
        self.tanfov = 1.0 / invtanfov
        self.opacity_threshold = opacity_threshold
        self.plan = None
        self.cfaces = None

    @classmethod
    def from_runtime(cls, rt) -> "FramePipeline":
        """The pipeline of a config-driven runtime (`cli/context.py:Runtime`):
        its EHM, faces, UV tables, modules and raster settings, its
        image_size, invtanfov and opacity_threshold, and the renderer's
        refiner options (counterpart of the JAX `FramePipeline(rt, params)`)."""
        m, st = rt.cfg.MODEL, rt.statics
        return cls(
            rt.ehm, st.faces, st.renderer.neural_refiner,
            inferer=st.inferer, uv_tables=(st.uvmap_f_idx, st.uvmap_f_bary, st.uvmap_mask),
            image_size=int(m.image_size), invtanfov=float(m.invtanfov),
            settings=st.renderer.settings,
            opacity_threshold=float(m.get("opacity_threshold", 0.001)),
            refiner_size=st.renderer.refiner_size, refiner_dtype=st.renderer.refiner_dtype,
            device=rt.device)

    def prepare_avatar(self, avatar: GaussianAvatar) -> GaussianAvatar:
        """Prune, then (when the UV count allows it) build the face-sort
        plan and face-sort the UV set, so frames take the planned gather."""
        avatar = prune_avatar(avatar, self.opacity_threshold)
        self.plan = self.cfaces = None
        if avatar.uv_local_xyz.shape[1] % 256 == 0:
            plan = build_face_sort_plan(avatar.uv_binding_face.cpu().numpy(),
                                        avatar.uv_valid.cpu().numpy())
            avatar = sort_avatar_by_plan(avatar, plan)
            self.plan = plan.to(self.device)
            self.cfaces = torch.as_tensor(
                compact_faces(plan, self.faces.cpu().numpy()), device=self.device)
        return avatar

    @torch.no_grad()
    def infer_avatar(self, source: dict, prune: bool = True) -> tuple[GaussianAvatar, dict]:
        """One-shot avatar from a source record. With `prune`, the avatar
        comes back pruned, padded and planned as `prepare_avatar` leaves it;
        without, as the network gave it, and frames take the row gather."""
        if self.inferer is None:
            raise RuntimeError("this pipeline was built without an inferer")
        f_idx, f_bary, mask = self.uv_tables
        body, flame = _unpack_params(_batched_params(source["params"], self.device))
        image = torch.as_tensor(source["image"], dtype=torch.float32, device=self.device)[None]
        w2c = torch.as_tensor(source["w2c"], dtype=torch.float32, device=self.device)[None]
        avatar, extra = build_avatar(
            self.inferer, self.ehm, self.faces, f_idx, f_bary, mask, image, w2c, body, flame,
            image_size=self.image_size, invtanfov=self.invtanfov)
        if prune:
            avatar = self.prepare_avatar(avatar)
        else:
            self.plan = self.cfaces = None
        return avatar, extra

    @torch.no_grad()
    def render_frame(self, avatar: GaussianAvatar, target: dict) -> dict:
        """-> {"render": (H, W, 3) in [0, 1], "raw": (H, W, 3) in [0, 1],
        "invdepth": (H, W)}."""
        body, flame = _unpack_params(_batched_params(target["params"], self.device))
        gs = deform_avatar(avatar, self.ehm, self.faces, body, flame,
                           plan=self.plan, compact_faces=self.cfaces)
        w2c = torch.as_tensor(target["w2c"], dtype=torch.float32, device=self.device)
        cam = Camera.from_w2c(w2c, self.tanfov, self.image_size, self.image_size)
        out = self.renderer(gs, cam)
        return {
            "render": torch.clamp(out.renders[0], 0, 1),
            "raw": torch.clamp(out.raw_renders[0], 0, 1),
            "invdepth": out.invdepth[0],
        }

    def render_frames(self, avatar: GaussianAvatar, targets: list, group: int) -> list[dict]:
        """Frames in groups of `group`. The JAX package fuses a group into one
        two-phase device program (a TPU scheduling device); here each frame
        runs as `render_frame` does, so the images are the same."""
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        return [self.render_frame(avatar, t) for t in targets]
