"""Avatar state, per-frame deformation and the Gaussian renderer."""
