"""Inference surfaces (the per-frame render pipeline)."""
