"""One-shot avatar creation, per-frame rendering and the inference drivers
(counterpart of `guava_renderer_tpu/cli/inference.py`).

Creation is: EHM forward -> mesh z-buffer visibility (kernel K5) ->
DINO+DPT encoder -> vertex and UV branches -> prune -> face-sort plan.
A frame is: EHM forward -> deform (planned face gather, kernel K2) ->
project -> bin -> tile blend (kernel K1) -> refiner (StyleUNet-small by
default; the renderer's options choose SimpleUNet, another refiner size and
a bf16 refiner).

The drivers (ref: main/test.py:21-278) run that pipeline over a dataset:
`render_set` is the timed self-reenactment (a warm-up and a timed creation,
the avatar's PLY, a warm-up and timed frames, gt/ and render/ PNGs, a
side-by-side MP4 and speed_info.json with {infer_time ms, render_speed
fps}); `render_cross_set` drives one identity with another video's motion;
`render_novel_views` orbits the camera. Each builds one
`FramePipeline.from_runtime(rt)` a call. Times are taken with the device
synchronized (`utils/logging_utils.py:SpeedMeter`). Run on every rank of a
process group (`parallel/mesh.py`), `render_set(dp_frames=True)` splits
each video's frames over the ranks (`parallel/batch_render.py`).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..avatar.deformer import deform_avatar, sort_avatar_by_plan
from ..avatar.inferer import UbodyGaussianInferer, build_avatar
from ..avatar.renderer import GaussianRenderer, NeuralRefiner
from ..avatar.state import GaussianAvatar, prune_avatar
from ..bodymodel.ehm import BodyParams, EhmModel, FlameParams
from ..core.cameras import Camera
from ..data.codec import write_image
from ..device import resolve_device
from ..ops.facegather import build_face_sort_plan, compact_faces
from ..ops.gsplat import RasterizeSettings
from ..parallel.batch_render import make_batch_frame_renderer, pad_to_multiple
from ..parallel.mesh import barrier, broadcast_object, current_group
from ..utils.camera_orbit import generate_novel_view_poses
from ..utils.logging_utils import SpeedMeter, span, spanned
from ..utils.ply import save_gaussian_ply
from ..utils.video import to_uint8, write_video

# identity/pose keys a target record may carry
_PARAM_KEYS = (
    "shape", "body_pose", "global_pose", "left_hand_pose", "right_hand_pose",
    "exp", "joints_offset", "head_scale", "hand_scale",
    "flame_shape", "flame_exp", "flame_jaw", "flame_eyes", "flame_eyelids",
)


def _batched_params(rec_params: dict, device: torch.device) -> dict:
    """Records are per-frame (unbatched): add the batch dim to every known key."""
    with span("guava.sync.params"):     # each an upload from pageable host memory
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

    @spanned("guava.render_frame")
    @torch.no_grad()
    def render_frame(self, avatar: GaussianAvatar, target: dict) -> dict:
        """-> {"render": (H, W, 3) in [0, 1], "raw": (H, W, 3) in [0, 1],
        "invdepth": (H, W)}."""
        body, flame = _unpack_params(_batched_params(target["params"], self.device))
        gs = deform_avatar(avatar, self.ehm, self.faces, body, flame,
                           plan=self.plan, compact_faces=self.cfaces)
        with span("guava.sync.params"):
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


def _save_png(path: str, img) -> None:
    """[0, 1] RGB -> PNG, quantized by truncation as the JAX package's
    `_save_png` does (its pixels; the file's bytes are the port's codec's)."""
    write_image(path, to_uint8(img))


_write_video = write_video


def _pipeline(rt, params) -> FramePipeline:
    """The drivers' pipeline over the runtime's modules. `params` is what
    `cli/context.py:load_model_params` returned: those same modules."""
    if params is not None and (params["inferer"] is not rt.inferer
                               or params["renderer"] is not rt.renderer):
        raise ValueError("params must be the runtime's own modules, as "
                         "load_model_params(rt, ...) returns them")
    return FramePipeline.from_runtime(rt)


def infer_avatar(rt, params, source: dict, prune: bool = True):
    """Convenience wrapper (one-off; loops should hold a FramePipeline)."""
    return _pipeline(rt, params).infer_avatar(source, prune=prune)


def render_frame(rt, params, avatar, target: dict) -> dict:
    """Convenience wrapper (one-off; loops should hold a FramePipeline)."""
    out = _pipeline(rt, params).render_frame(avatar, target)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _timed_creation(pipe: FramePipeline, speed: SpeedMeter, source: dict):
    """A warm-up creation, then the timed one (ref: test.py:41-50)."""
    pipe.infer_avatar(source)
    with speed.time_infer():
        avatar, _ = pipe.infer_avatar(source)
    return avatar


def _export_ply(path: str, avatar, faces) -> None:
    from ..avatar.deformer import canonical_gaussians

    with torch.no_grad():
        gs = canonical_gaussians(avatar, faces)
    save_gaussian_ply(path, *(t[0].cpu().numpy() for t in (
        gs.xyz, gs.colors[..., :3], gs.opacity, gs.scaling, gs.rotation)))


def _replicate_avatar(pipe: FramePipeline, avatar, group):
    """Rank 0's created avatar, plan and compact faces on every rank's pipeline."""
    payload = None
    if group.rank == 0:
        payload = (GaussianAvatar(*(t.cpu() for t in avatar)),
                   None if pipe.plan is None else pipe.plan.to("cpu"),
                   None if pipe.cfaces is None else pipe.cfaces.cpu())
    av, plan, cfaces = broadcast_object(payload, group)
    pipe.plan = None if plan is None else plan.to(pipe.device)
    pipe.cfaces = None if cfaces is None else cfaces.to(pipe.device)
    return GaussianAvatar(*(t.to(pipe.device) for t in av))


class _Targets:
    """The target records of dataset indices, loaded when sliced."""

    def __init__(self, dataset, indices: list):
        self.dataset, self.indices = dataset, indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, sel: slice) -> list:
        return [self.dataset[i]["target"] for i in self.indices[sel]]


def render_set(rt, params, dataset, save_path: str, saving_name: str = "render",
               max_frames: int | None = None, export_ply: bool = True,
               dp_frames: bool = False, group_frames: int = 0) -> dict:
    """Self-reenactment over the test frames of each video (ref: test.py:30-94).

    group_frames=G>1 renders through `FramePipeline.render_frames` in groups
    of G, timed as one region per call as the JAX package times it.

    dp_frames on every rank of a process group of n > 1 (`parallel/mesh.py`;
    `cli.test --devices n --dp_render` starts them) renders each video's
    frames data-parallel: rank 0 creates the avatar (timed) and writes its
    PLY, every rank gets rank 0's avatar and plan, the frames are padded to
    a multiple of n with the last one and split over the ranks, gathered
    once, and rank 0 writes every PNG, the video and speed_info.json. Rank 0
    returns the results, the other ranks {}. Outside a group, or in a group
    of one, dp_frames renders sequentially, as the JAX package does on one
    device: a process drives one device."""
    os.makedirs(save_path, exist_ok=True)
    pipe = _pipeline(rt, params)
    group = current_group()
    dp = dp_frames and group is not None and group.size > 1
    lead = not dp or group.rank == 0
    brend = make_batch_frame_renderer(pipe, group) if dp else None

    by_video: dict[str, list[int]] = {}
    for i, key in enumerate(dataset.frames):
        by_video.setdefault(key.split("/")[0], []).append(i)

    results = {}
    for vid, idxs in by_video.items():
        speed = SpeedMeter(pipe.device)
        scene_dir = os.path.join(save_path, vid)
        rdir = os.path.join(scene_dir, saving_name)
        gdir = os.path.join(scene_dir, "gt")
        if lead:
            os.makedirs(rdir, exist_ok=True)
            os.makedirs(gdir, exist_ok=True)

        avatar = None
        if lead:
            avatar = _timed_creation(pipe, speed, dataset[idxs[0]]["source"])
            if export_ply:
                _export_ply(os.path.join(scene_dir, "avatar.ply"), avatar, pipe.faces)
        if dp:
            avatar = _replicate_avatar(pipe, avatar, group)

        sel = idxs if max_frames is None else idxs[:max_frames]
        frames = []

        def dump(i, rec, out):
            name = f"{i:06d}.png"
            gt = to_uint8(np.asarray(rec["target"]["image"]) * np.asarray(rec["target"]["mask"]))
            render = to_uint8(out["render"].cpu().numpy())
            _save_png(os.path.join(gdir, name), gt)
            _save_png(os.path.join(rdir, name), render)
            frames.append(np.concatenate([gt, render], axis=1))

        if dp and sel:
            targets = _Targets(dataset, pad_to_multiple(sel, group.size)[0])
            for t in targets[slice(group.rank, group.rank + 1)]:    # warm-up
                pipe.render_frame(avatar, t)
            barrier(group)
            with speed.time_frames(len(sel)):
                renders, _ = brend(avatar, targets)
            if lead:
                for j, i in enumerate(sel):
                    dump(i, dataset[i], {"render": renders[j]})
        elif group_frames > 1 and sel:
            recs = [dataset[i] for i in sel]
            targets = [r["target"] for r in recs]
            pipe.render_frames(avatar, targets[:group_frames], group_frames)   # warm-up
            with speed.time_frames(len(sel)):
                outs = pipe.render_frames(avatar, targets, group_frames)
            for i, rec, out in zip(sel, recs, outs):
                dump(i, rec, out)
        else:
            if sel:        # warm-up, so the timed loop measures the steady state
                pipe.render_frame(avatar, dataset[sel[0]]["target"])
            for i in sel:
                rec = dataset[i]
                with speed.time_frame():
                    out = pipe.render_frame(avatar, rec["target"])
                dump(i, rec, out)
        if lead:
            _write_video(os.path.join(scene_dir, f"{vid}_compare.mp4"), frames)
            speed.dump(os.path.join(scene_dir, "speed_info.json"))
            results[vid] = {"frames": len(sel), "infer_time_ms": speed.infer_time_ms,
                            "render_fps": speed.render_fps}
    if dp:
        barrier(group)
    return results


def change_id_info(target_params: dict, source_params: dict) -> dict:
    """Swap identity fields from the source into the target motion
    (ref: main/test.py:21-28)."""
    out = dict(target_params)
    for k in ("shape", "joints_offset", "head_scale", "hand_scale", "flame_shape"):
        if k in source_params:
            out[k] = source_params[k]
    return out


def render_cross_set(rt, params, source_dataset, target_dataset, save_path: str,
                     keep_source_cam: bool = False, max_frames: int | None = None) -> None:
    """Cross-reenactment (ref: main/test.py:96-139), with speed_info.json as
    the self-reenactment writes it."""
    os.makedirs(save_path, exist_ok=True)
    pipe = _pipeline(rt, params)
    speed = SpeedMeter(pipe.device)
    src = source_dataset[0]
    avatar = _timed_creation(pipe, speed, src["source"])
    n = len(target_dataset) if max_frames is None else min(max_frames, len(target_dataset))
    frames = []
    for i in range(n):
        tgt = dict(target_dataset[i]["target"])
        tgt["params"] = change_id_info(tgt["params"], src["source"]["params"])
        if keep_source_cam:
            tgt["w2c"] = src["source"]["w2c"]
        with speed.time_frame():
            out = pipe.render_frame(avatar, tgt)
        render = to_uint8(out["render"].cpu().numpy())
        _save_png(os.path.join(save_path, f"{i:06d}.png"), render)
        frames.append(render)
    _write_video(os.path.join(save_path, "cross_reenact.mp4"), frames)
    speed.dump(os.path.join(save_path, "speed_info.json"))


def render_novel_views(rt, params, dataset, save_path: str, static: bool = False,
                       frame_idx: int = 0, num_keyframes: int = 120) -> None:
    """Orbit renders, static pose or animated (ref: main/test.py:141-216),
    with speed_info.json."""
    os.makedirs(save_path, exist_ok=True)
    pipe = _pipeline(rt, params)
    speed = SpeedMeter(pipe.device)
    first = dataset[frame_idx]
    avatar = _timed_creation(pipe, speed, first["source"])
    c2w = np.linalg.inv(np.asarray(first["target"]["w2c"]))
    frames = []
    for i, w2c in enumerate(generate_novel_view_poses(c2w, num_keyframes=num_keyframes)):
        rec = first if static else dataset[min(i, len(dataset) - 1)]
        tgt = dict(rec["target"])
        tgt["w2c"] = w2c
        with speed.time_frame():
            out = pipe.render_frame(avatar, tgt)
        render = to_uint8(out["render"].cpu().numpy())
        _save_png(os.path.join(save_path, f"{i:06d}.png"), render)
        frames.append(render)
    _write_video(os.path.join(save_path, "novel_views.mp4"), frames)
    speed.dump(os.path.join(save_path, "speed_info.json"))
