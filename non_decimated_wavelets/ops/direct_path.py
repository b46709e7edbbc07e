"""Direct (spatial-domain stencil) path for the non-decimated DWT.

Generalizes the reference's hand-unrolled Haar stencil classes
(``Functions/harr_nddwt_2D.m:250-287``, ``Functions/harr_nddwt_4D.m:248-552``
— two-tap circular sums/differences per axis) to arbitrary even-length
filters: each axis pass is a K-tap periodic circular correlation

    ``y_c[n] = sum_j taps_c[j] * x[(n + j - (K//2 - 1)) % N]``

which is numerically identical to the reference's FFT path with its
half-filter-length phase advance (verified to ~1e-15 during the survey;
``Functions/nd_dwt_1D.m:274``).

Properties:

* real inputs stay real end-to-end (no complex intermediates — half the
  memory traffic of the FFT path on real data);
* expressed as static slices of one circular pad feeding fused
  multiply-adds, which XLA fuses into a handful of memory passes;
* the arithmetic runs in the taps' dtype: a bfloat16 plan passes float32
  taps, so bf16 arrays are upcast inside the fusion, accumulated in f32 and
  rounded back to bf16 once per level (no extra bytes moved).

Layout: band-first ``(B, *spatial)`` as in ``ops/fft_path.py``; the public
API transposes to the reference's ``[n1..nd, B]``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _circ_pad(x: jnp.ndarray, axis: int, left: int, right: int) -> jnp.ndarray:
    """Circularly pad one axis: [x[-left:], x, x[:right]]."""
    n = x.shape[axis]
    parts = []
    if left:
        parts.append(jax.lax.slice_in_dim(x, n - left, n, axis=axis))
    parts.append(x)
    if right:
        parts.append(jax.lax.slice_in_dim(x, 0, right, axis=axis))
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else x


def _corr_pair(x: jnp.ndarray, taps: jnp.ndarray, axis: int):
    """One axis pass: (lo, hi) K-tap circular correlations sharing reads.

    ``taps``: (2, K) real array (lo row 0, hi row 1). Implemented as one
    circular pad plus K static slices feeding both outputs, so XLA can fuse
    the slice+multiply+add chain over the padded buffer into one pass. The
    two outputs share every read — the same sharing the reference's batched
    FFTW plan exploits across subbands (``mex/nddwt.c:45-47``).
    """
    K = taps.shape[1]
    o = K // 2 - 1
    n = x.shape[axis]
    xp = _circ_pad(x, axis, o, K - 1 - o)
    acc_lo = None
    acc_hi = None
    for j in range(K):
        r = jax.lax.slice_in_dim(xp, j, j + n, axis=axis)
        tl = taps[0, j] * r
        th = taps[1, j] * r
        acc_lo = tl if acc_lo is None else acc_lo + tl
        acc_hi = th if acc_hi is None else acc_hi + th
    return acc_lo, acc_hi


def _adj_pair(lo: jnp.ndarray, hi: jnp.ndarray, taps: jnp.ndarray, axis: int):
    """Adjoint of :func:`_corr_pair`: sum of the two transposed correlations.

    The adjoint of ``y[n] = sum_j t[j] x[n+j-o]`` is
    ``x[m] = sum_j t[j] y[m-j+o]`` (real taps, so the frequency-domain
    conjugate of the reference's ``rec`` — ``Functions/nd_dwt_3D.m:374`` —
    is exactly this transposed stencil). ``y[m-j+o]`` sits at padded index
    ``m + K-1-j`` after a (K-1-o, o) circular pad.
    """
    K = taps.shape[1]
    o = K // 2 - 1
    n = lo.shape[axis]
    lp = _circ_pad(lo, axis, K - 1 - o, o)
    hp = _circ_pad(hi, axis, K - 1 - o, o)
    acc = None
    for j in range(K):
        start = K - 1 - j
        rl = jax.lax.slice_in_dim(lp, start, start + n, axis=axis)
        rh = jax.lax.slice_in_dim(hp, start, start + n, axis=axis)
        term = taps[0, j] * rl + taps[1, j] * rh
        acc = term if acc is None else acc + term
    return acc


def compute_dtype(dtype, taps: tuple):
    """Arithmetic dtype of a transform: the array's dtype promoted with the
    taps' (bf16 arrays with f32 taps compute in f32; complex stays
    complex)."""
    return jnp.promote_types(dtype, taps[0].dtype)


def _level1_dec(x: jnp.ndarray, taps: tuple) -> jnp.ndarray:
    """(2^d, *spatial) bands from (*spatial); band bit k = H on axis k."""
    ndim = len(taps)
    T = x[None].astype(compute_dtype(x.dtype, taps))
    for ax in range(ndim):
        sp_axis = T.ndim - ndim + ax
        lo, hi = _corr_pair(T, taps[ax], sp_axis)
        T = jnp.concatenate([lo, hi], axis=0)
    return T


def _level1_rec(group: jnp.ndarray, taps: tuple) -> jnp.ndarray:
    """Adjoint of :func:`_level1_dec`: (2^d, *spatial) -> (*spatial)."""
    ndim = len(taps)
    T = group.astype(compute_dtype(group.dtype, taps))
    for ax in reversed(range(ndim)):
        nb = T.shape[0]
        sp_axis = T.ndim - ndim + ax
        T = _adj_pair(T[: nb // 2], T[nb // 2 :], taps[ax], sp_axis)
    return T[0] if T.ndim > ndim else T


@partial(jax.jit, static_argnames=("level",))
def dec_direct(x: jnp.ndarray, taps: tuple, level: int) -> jnp.ndarray:
    """Multilevel analysis, direct path. Returns ``(B, *spatial)``.

    The cascade re-filters the full-resolution approximation with the same
    (undilated) taps each level, exactly as the reference does
    (``Functions/nd_dwt_1D.m:181``).
    """
    groups = []
    approx = x
    for _ in range(level):
        bands = _level1_dec(approx, taps).astype(x.dtype)
        approx = bands[0]
        groups.append(bands[1:])
    parts = [approx[None]]
    for g in reversed(groups):
        parts.append(g)
    return jnp.concatenate(parts, axis=0)


@partial(jax.jit, static_argnames=("level", "preserve_l2"))
def rec_direct(
    y: jnp.ndarray, taps: tuple, level: int, preserve_l2: bool
) -> jnp.ndarray:
    """Multilevel synthesis, direct path, from ``(B, *spatial)`` bands.

    Extra dims between the band axis and the spatial axes (batch,
    split-complex pairs) pass through untouched."""
    ndim = len(taps)
    nb = 2**ndim

    def synth(group):
        acc = _level1_rec(group, taps)
        if not preserve_l2:
            acc = acc / nb
        return acc.astype(y.dtype)

    # Synthesis runs deepest level first.
    acc = synth(y[:nb])
    pos = nb
    for _ in range(level - 1):
        group = jnp.concatenate([acc[None], y[pos : pos + nb - 1]], axis=0)
        acc = synth(group)
        pos += nb - 1
    return acc
