from .denoise import denoise, hard_threshold, shrink_details, soft_threshold
from .cs_recon import fista_cs_mri, fista_inpaint, fista_inpaint_split, ista_step

__all__ = [
    "denoise",
    "soft_threshold",
    "hard_threshold",
    "shrink_details",
    "fista_cs_mri",
    "fista_inpaint",
    "fista_inpaint_split",
    "ista_step",
]
