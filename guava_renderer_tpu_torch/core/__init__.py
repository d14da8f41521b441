"""Geometry primitives: rotations, cameras, linear blend skinning."""
