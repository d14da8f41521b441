"""Offline rendering with frames data-parallel over the ranks (counterpart of
`guava_renderer_tpu/parallel/batch_render.py`).

Playback of one avatar over many target poses is parallel in frames: the
avatar and the refiner are replicated, the frames are split over the ranks,
and every rank renders its contiguous share through
`FramePipeline.render_frame` (the planned deform, kernel K2, and the tile
blend, kernel K1, a frame), with no collective until the frames are
gathered once at the end. `parallel/sharded_render.py` splits one frame's
rows instead.
"""

from __future__ import annotations

import torch

from .mesh import Group, all_gather_cat, local_slice


def make_batch_frame_renderer(pipe, group: Group):
    """-> render(avatar, targets) -> (renders (B, H, W, 3), raws (B, H, W, 3)),
    every rank's frames gathered on every rank in target order. `pipe` is
    this rank's `cli.inference.FramePipeline` (its plan and compact faces
    those of `avatar`, as `infer_avatar` or `prepare_avatar` left them), and
    `targets` the B target records, B a multiple of the ranks
    (`pad_to_multiple`); rank r renders targets [r·B/n, (r+1)·B/n)."""

    def render(avatar, targets: list):
        mine = targets[local_slice(len(targets), group)]
        outs = [pipe.render_frame(avatar, t) for t in mine]
        renders = torch.stack([o["render"] for o in outs])
        raws = torch.stack([o["raw"] for o in outs])
        return all_gather_cat(renders, group), all_gather_cat(raws, group)

    return render


def pad_to_multiple(items: list, multiple: int):
    """A list of per-frame records padded to a multiple by repeating the last
    (the JAX `pad_to_multiple` on one leaf); -> (padded, original_length)."""
    return items + items[-1:] * (-len(items) % multiple), len(items)
