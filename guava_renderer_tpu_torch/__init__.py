"""GUAVA avatars on PyTorch + CUDA (NVIDIA Hopper).

A port of the serving paths of `guava_renderer_tpu` (the JAX reference,
which stays untouched beside it):
  * one-shot avatar creation: EHM body model -> mesh z-buffer visibility ->
    DINO+DPT encoder -> vertex and UV Gaussian decoders -> prune;
  * per-frame animation: EHM -> UV-Gaussian deformation -> projection ->
    tile binning -> tile blend -> StyleUNet refiner.
The hand-written CUDA kernels (tile blend, face-table gather, mesh
z-buffer) live in `csrc/` and are built on first use (`kernels/build.py`).

Entry points take `device=` and default to "cuda"; they raise when no GPU is
present unless the caller asks for "cpu" explicitly.
"""
