"""Frozen copies of the port's plain module code, as the reference needs it.

Copied from `guava_renderer_tpu_torch/` at the commit that added the
benchmark, with the package's relative imports kept: `core/` (cameras,
LBS, rotations), `bodymodel/` (the synthetic rig, its UV tables, the EHM),
`avatar/` (the avatar state and its prune, the row-gather deform and the
face-sort order, the inferer with its sampling), `ops/` (projection, the
face-sort plan, the mesh z-buffer's binning), `models/` (the bilinear
resize, ViT, the DPT encoder, the decoders, StyleUNet), `train/` (the
losses, LPIPS), `data/` (the record store, the JPEG and PNG codec with the
area resize, the tracked dataset, the synthetic dataset writer),
`native/` (the codec's and the store's C++, built with g++ on first use)
and `device.py`. The edits: the deformer keeps its row gather and drops
the kernel path (K2), which computes the same rows; `kernels/meshraster.py`
keeps the z-buffer's plain walk (K5 is held to it bit for bit);
`native/__init__.py` builds into `build/perfbench/host/`. Later changes to
the port do not reach these files, so the reference stays the yardstick it
was.
"""
