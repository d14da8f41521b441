"""Refiner networks (StyleUNet-small) and their layers."""
