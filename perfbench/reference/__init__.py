"""The plain reference that decides `correct`: PyTorch and NumPy only, and
nothing of `guava_renderer_tpu_torch` (its plain module code is frozen
under `frozen/`)."""
