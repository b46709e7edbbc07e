"""Non-decimated (undecimated / stationary) wavelet transform in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference MATLAB+MEX library ``arg-min-x/Non-Decimated_Wavelets``:
multidimensional (1D-4D and beyond) non-decimated DWT with periodic boundary
conditions, Daubechies db1..dbN filters (optionally one per axis), multilevel
analysis/synthesis with exact reconstruction, tight-frame (``preserve_l2``)
normalization, float32/float64, real or complex data — plus what the
reference never had: jit/vmap/grad-compatible functional transforms that
XLA compiles for the GPU (or the CPU), and multi-device spatial sharding
with periodic halo exchange over a ``jax.sharding.Mesh``.
"""

from .filters import (
    correlation_taps,
    daubechies_taps,
    decomposition_filters,
    frequency_response,
    qmf_highpass,
)
from .oracle import level_from_bands, num_bands
from .plan import NDDWT
from .api import (
    nd_dwt_1D,
    nd_dwt_2D,
    nd_dwt_3D,
    nd_dwt_4D,
    harr_nddwt_2D,
    harr_nddwt_4D,
)

__version__ = "0.1.0"

__all__ = [
    "NDDWT",
    "nd_dwt_1D",
    "nd_dwt_2D",
    "nd_dwt_3D",
    "nd_dwt_4D",
    "harr_nddwt_2D",
    "harr_nddwt_4D",
    "correlation_taps",
    "daubechies_taps",
    "decomposition_filters",
    "frequency_response",
    "qmf_highpass",
    "num_bands",
    "level_from_bands",
]
