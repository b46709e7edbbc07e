"""Pure-NumPy golden oracle for the non-decimated DWT.

Implements the *exact* semantics of the reference transform classes
(``Functions/nd_dwt_{1,2,3,4}D.m``) in float64 NumPy, dimension-generically:

* per level, ``2^d`` bands obtained by circular correlation with separable
  outer-product kernels, each advanced by half the filter length per axis via
  a frequency-domain phase factor (``Functions/nd_dwt_2D.m:285-291``);
* the approximation band is re-filtered at full resolution every level with
  the *same* (undilated) filters (``Functions/nd_dwt_1D.m:181``) and the new
  level's bands are *prepended* (``cat`` at ``Functions/nd_dwt_3D.m:184``);
* band layout ``[n1..nd, B]`` with ``B = 2^d + (2^d - 1)(L - 1)``; band 0 is
  the deepest approximation; within a level's group the *first* axis' filter
  toggles fastest (``Functions/nd_dwt_3D.m:334-341``);
* analysis filters carry ``1/sqrt(2^d)`` iff ``preserve_l2``
  (``Functions/nd_dwt_3D.m:323-327``); reconstruction is the adjoint
  (conjugate filters, ``Functions/nd_dwt_3D.m:374``) with a ``/2^d`` per
  level iff not preserving (``Functions/nd_dwt_3D.m:233-235``);
* real input -> real output (``Functions/nd_dwt_3D.m:150-154,190-192``);
  complex inputs are transformed natively;
* the reconstruction level is inferred from the band count
  (``Functions/nd_dwt_3D.m:217``).

This module is the test anchor: the JAX engine (FFT and direct
paths) must agree with it to <=1e-12 in float64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .filters import frequency_response, parse_wavelet_name


def _normalize_wavelets(wavelets, ndim: int) -> tuple:
    if isinstance(wavelets, str):
        return (wavelets,) * ndim
    wavelets = tuple(wavelets)
    if len(wavelets) != ndim:
        raise ValueError(
            f"Expected 1 or {ndim} wavelet names for a {ndim}-D transform, "
            f"got {len(wavelets)}"
        )
    for w in wavelets:
        parse_wavelet_name(w)
    return wavelets


def num_bands(ndim: int, level: int) -> int:
    """B = 2^d + (2^d - 1)(L - 1)  (``mex/nd_dwt_mex.c:83-86``)."""
    nb = 2**ndim
    return nb + (nb - 1) * (level - 1)


def level_from_bands(ndim: int, bands: int) -> int:
    """Invert :func:`num_bands` (``Functions/nd_dwt_3D.m:217`` etc.)."""
    nb = 2**ndim
    level, rem = divmod(bands - nb, nb - 1)
    if rem != 0 or level < 0:
        raise ValueError(
            f"{bands} bands is not a valid {ndim}-D multilevel layout "
            f"(expected {nb} + {nb - 1}*(L-1))"
        )
    return level + 1


def axis_responses(
    wavelets, shape: Sequence[int], preserve_l2: bool
) -> list[np.ndarray]:
    """Per-axis (2, N_k) complex128 frequency responses, reference scaling.

    The reference caches the full 2^d outer-product kernels
    (``Functions/nd_dwt_2D.m:305-308``, 2^d x numel complex storage); the
    product of these separable per-axis responses is numerically identical
    and needs only ``2 * sum(N_k)`` storage.  The tight-frame scale
    ``1/sqrt(2^d)`` is folded in as ``1/sqrt(2)`` per axis.
    """
    ndim = len(shape)
    wavelets = _normalize_wavelets(wavelets, ndim)
    scale = 1.0 / np.sqrt(2.0) if preserve_l2 else 1.0
    return [
        scale * frequency_response(w, int(n)) for w, n in zip(wavelets, shape)
    ]


def _band_freq(Xf: np.ndarray, resp: list[np.ndarray], band: int) -> np.ndarray:
    """Multiply the spectrum by the separable response of one band.

    Band bit k (axis k) selects low (0) or high (1); bit 0 toggles fastest,
    matching the reference order LL, HL, LH, HH, ... (``nd_dwt_2D.m:305-308``).
    """
    out = Xf
    for ax, F in enumerate(resp):
        sel = (band >> ax) & 1
        shape = [1] * Xf.ndim
        shape[ax] = F.shape[1]
        out = out * F[sel].reshape(shape)
    return out


def _level1_dec_freq(Xf: np.ndarray, resp: list[np.ndarray]) -> np.ndarray:
    """All 2^d frequency-domain bands, stacked on a trailing band axis."""
    ndim = Xf.ndim
    return np.stack(
        [_band_freq(Xf, resp, b) for b in range(2**ndim)], axis=-1
    )


def dec(
    x: np.ndarray,
    wavelets,
    level: int,
    preserve_l2: bool = False,
) -> np.ndarray:
    """Multilevel non-decimated analysis; returns ``[n1..nd, B]`` complex/real.

    Matches ``Functions/nd_dwt_{1,2,3,4}D.m dec`` exactly, including the
    prepend ordering of deeper levels and real-in -> real-out behavior.
    """
    x = np.asarray(x)
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    real_in = not np.iscomplexobj(x)
    shape = x.shape
    ndim = x.ndim
    resp = axis_responses(wavelets, shape, preserve_l2)

    axes = tuple(range(ndim))
    Xf = np.fft.fftn(x, axes=axes)
    groups = []  # detail groups, shallow level first as produced
    approx_f = Xf
    for _ in range(level):
        bands_f = _level1_dec_freq(approx_f, resp)
        # Carry the approximation in the frequency domain (identical to the
        # reference's ifftn-then-fftn round trip, minus two FFTs per level).
        approx_f = bands_f[..., 0]
        groups.append(bands_f[..., 1:])
    parts = [np.fft.ifftn(approx_f, axes=axes)[..., None]]
    # Deepest level's details first, level-1 details last (the reference's
    # cat-prepend at Functions/nd_dwt_3D.m:184).
    for g in reversed(groups):
        parts.append(np.fft.ifftn(g, axes=axes))
    y = np.concatenate(parts, axis=-1)
    if real_in:
        y = y.real
    return y


def rec(
    y: np.ndarray,
    wavelets,
    preserve_l2: bool = False,
) -> np.ndarray:
    """Multilevel non-decimated synthesis (adjoint of :func:`dec` up to the
    per-level ``/2^d``); level inferred from the band count."""
    y = np.asarray(y)
    real_in = not np.iscomplexobj(y)
    ndim = y.ndim - 1
    shape = y.shape[:-1]
    nb = 2**ndim
    level = level_from_bands(ndim, y.shape[-1])
    resp = axis_responses(wavelets, shape, preserve_l2)

    axes = tuple(range(ndim))
    Yf = np.fft.fftn(y, axes=axes)

    def synth(group_f: np.ndarray) -> np.ndarray:
        acc = np.zeros(shape, dtype=np.complex128)
        for b in range(nb):
            acc = acc + _band_freq(group_f[..., b], [np.conj(F) for F in resp], b)
        return acc

    acc_f = synth(Yf[..., :nb])
    if not preserve_l2:
        acc_f = acc_f / nb
    pos = nb
    for _ in range(1, level):
        group = np.concatenate(
            [acc_f[..., None], Yf[..., pos : pos + nb - 1]], axis=-1
        )
        acc_f = synth(group)
        if not preserve_l2:
            acc_f = acc_f / nb
        pos += nb - 1
    x = np.fft.ifftn(acc_f, axes=axes)
    if real_in:
        x = x.real
    return x
