"""Face-sorted texel plan for the deformer's face-table gather (counterpart
of `guava_renderer_tpu/ops/facegather.py`).

STATIC plan (per avatar, numpy, built once): sort the texels by binding
face and renumber the bound faces compactly; invalid texels bind a dummy
trailing face. The per-frame gather of the compact face table by those
sorted ids is kernel K2 (`kernels/facegather.face_gather`, the counterpart
of `face_window_gather`); its backward, kernel K4, is a segmented sum over
the plan's `segment_starts`. The TPU plan's window bookkeeping
(chunk_block0, n_blocks) feeds its one-hot MXU kernels only and has no
counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_T = 256   # texel count granularity the plan requires (prune pads to 4096)


@dataclasses.dataclass(frozen=True, eq=False)
class FaceSortPlan:
    perm: np.ndarray            # (N,) texel permutation (sorted by face)
    inv_perm: np.ndarray        # (N,) inverse permutation
    compact_ids: np.ndarray | torch.Tensor  # (N,) i32 compact face id per SORTED texel
    used_faces: np.ndarray      # (Fc-1,) original face id per compact id
    n_texels: int
    n_compact: int              # Fc including the dummy face
    # (Fc+1,) i32: sorted texels [segment_starts[f], segment_starts[f+1]) bind face f
    segment_starts: np.ndarray | torch.Tensor

    def to(self, device) -> "FaceSortPlan":
        """The plan with `compact_ids` and `segment_starts` as int32 tensors
        on `device`, so the per-frame gather and its backward do not copy
        them from the host every frame."""
        ids = torch.as_tensor(self.compact_ids, dtype=torch.int32, device=device)
        seg = torch.as_tensor(self.segment_starts, dtype=torch.int32, device=device)
        return dataclasses.replace(self, compact_ids=ids, segment_starts=seg)


def segment_starts(compact_ids: np.ndarray, n_compact: int) -> np.ndarray:
    """Sorted compact ids (N,) -> (n_compact + 1,) i32 first sorted texel of
    each face (a face no texel binds has an empty segment)."""
    return np.searchsorted(np.asarray(compact_ids), np.arange(n_compact + 1),
                           side="left").astype(np.int32)


def build_face_sort_plan(binding_face: np.ndarray, valid: np.ndarray) -> FaceSortPlan:
    """Build the static plan from an avatar's flat binding table."""
    binding_face = np.asarray(binding_face).reshape(-1).astype(np.int64)
    valid = np.asarray(valid).reshape(-1).astype(bool)
    N = binding_face.shape[0]
    if N % _T:
        raise ValueError(f"texel count {N} must be a multiple of {_T}")

    used = np.unique(binding_face[valid])
    dummy = used.shape[0]
    safe = np.where(valid, binding_face, used[0] if used.size else 0)
    compact_unsorted = np.where(valid, np.searchsorted(used, safe), dummy)
    perm = np.argsort(compact_unsorted, kind="stable")
    inv_perm = np.argsort(perm, kind="stable")
    compact = compact_unsorted[perm].astype(np.int32)
    return FaceSortPlan(
        perm=perm.astype(np.int32),
        inv_perm=inv_perm.astype(np.int32),
        compact_ids=compact,
        used_faces=used.astype(np.int32),
        n_texels=N,
        n_compact=dummy + 1,
        segment_starts=segment_starts(compact, dummy + 1),
    )


def compact_faces(plan: FaceSortPlan, faces: np.ndarray) -> np.ndarray:
    """(F, 3) mesh faces -> (Fc, 3) compact-id face table. The trailing dummy
    face reuses a real triangle so its frame math stays NaN-free."""
    faces = np.asarray(faces)
    used = faces[plan.used_faces]
    dummy = used[:1] if used.size else faces[:1]
    return np.concatenate([used, dummy], axis=0).astype(np.int32)

