"""Rasterizer host side (projection, binning, packing) and the face plan."""
