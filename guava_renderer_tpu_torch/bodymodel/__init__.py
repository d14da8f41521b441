"""Body model: numpy assets (data, teeth, synthetic rig, loaders), the EHM
and standalone SMPL-X/FLAME forwards, landmarks and FLAME extras."""

from .data import (  # noqa: F401
    ParametricModelData,
    SmplxExtras,
    load_flame,
    load_smplx,
    parse_obj_uv,
    uv_face_tables,
)
from .ehm import EhmModel, ehm_forward  # noqa: F401
from .synthetic import synthetic_ehm, synthetic_model  # noqa: F401
