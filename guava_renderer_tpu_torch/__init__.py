"""GUAVA avatars on PyTorch + CUDA (NVIDIA Hopper).

A port of the per-frame animation path of `guava_renderer_tpu` (the JAX
reference, which stays untouched beside it): EHM body model -> UV-Gaussian
deformation -> projection -> tile binning -> tile blend -> StyleUNet
refiner. The two hand-written CUDA kernels (tile blend, face-table gather)
live in `csrc/` and are built on first use (`kernels/build.py`).

Entry points take `device=` and default to "cuda"; they raise when no GPU is
present unless the caller asks for "cpu" explicitly.
"""
