"""FFT (fast-convolution) path for the non-decimated DWT, XLA-native.

The reference's core design — cache frequency-domain filters once, then every
transform is FFT -> pointwise multiply -> inverse FFT
(``Functions/nd_dwt_3D.m:334-341,359-366``) — kept, with three changes:

* **separable responses**: per-axis ``(2, N_k)`` vectors broadcast-multiplied
  instead of the reference's cached ``2^d x numel`` full-size kernels
  (``Functions/nd_dwt_2D.m:305-308``) — same numbers, ``2^d x`` less filter
  memory and memory traffic;
* **frequency-domain cascade**: the running approximation is carried in the
  frequency domain between levels instead of the reference's
  ifftn-then-fftn round trip (``Functions/nd_dwt_3D.m:184``), saving two
  n-D FFTs per level in ``dec`` and per level in ``rec``;
* **band-first layout** internally ``(B, *spatial)`` so the trailing
  (contiguous) axes stay spatial; the public API transposes to the
  reference's ``[n1..nd, B]``.

All functions are shape/level-static and jit-compatible; arrays may be
float32/float64 (internally complex64/complex128) on any backend XLA
supports FFT for.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _spatial_axes(ndim: int, batch: int = 0) -> tuple:
    """FFT axes: the trailing ``ndim`` axes of a (band/batch-leading) array."""
    return tuple(range(-ndim, 0))


def _apply_band(Xf: jnp.ndarray, resp: tuple, band: int, conj: bool) -> jnp.ndarray:
    """Multiply spectrum by one band's separable response (bit0 = axis 0)."""
    ndim = len(resp)
    out = Xf
    for ax, F in enumerate(resp):
        sel = (band >> ax) & 1
        f = jnp.conj(F[sel]) if conj else F[sel]
        shape = [1] * out.ndim
        shape[out.ndim - ndim + ax] = f.shape[0]
        out = out * f.reshape(shape)
    return out


def _level1_dec_freq_ordered(Xf: jnp.ndarray, resp: tuple) -> jnp.ndarray:
    """(2^d, *spatial) frequency-domain bands from a (*spatial) spectrum.

    Band index bit k selects H on axis k; built as a separable cascade so
    axis-0's bit toggles fastest — the reference's band order
    (``Functions/nd_dwt_3D.m:334-341``).
    """
    ndim = len(resp)
    T = Xf[None]  # band axis size 1
    for ax in range(ndim):
        F = resp[ax]
        shape = [1] * T.ndim
        shape[T.ndim - ndim + ax] = F.shape[1]
        lo = T * F[0].reshape(shape)
        hi = T * F[1].reshape(shape)
        # hi block gets band indices [cur, 2*cur): bit `ax` = 1, existing
        # bits preserved -> concatenation keeps bit0 fastest.
        T = jnp.concatenate([lo, hi], axis=0)
    return T


@partial(jax.jit, static_argnames=("level", "real_out"))
def dec_fft(x: jnp.ndarray, resp: tuple, level: int, real_out: bool) -> jnp.ndarray:
    """Multilevel analysis. Returns ``(B, *spatial)``, deepest approx first.

    ``resp``: tuple of per-axis (2, N_k) complex responses with any
    tight-frame scale already folded in (see ``plan.NDDWT``).
    """
    ndim = x.ndim
    axes = _spatial_axes(ndim)
    cdtype = resp[0].dtype
    Xf = jnp.fft.fftn(x.astype(cdtype), axes=axes)
    groups = []
    approx_f = Xf
    for _ in range(level):
        bands_f = _level1_dec_freq_ordered(approx_f, resp)
        approx_f = bands_f[0]
        groups.append(bands_f[1:])
    parts = [jnp.fft.ifftn(approx_f, axes=axes)[None]]
    for g in reversed(groups):
        parts.append(jnp.fft.ifftn(g, axes=axes))
    y = jnp.concatenate(parts, axis=0)
    if real_out:
        y = y.real
    return y


@partial(jax.jit, static_argnames=("level", "preserve_l2", "real_out"))
def rec_fft(
    y: jnp.ndarray,
    resp: tuple,
    level: int,
    preserve_l2: bool,
    real_out: bool,
) -> jnp.ndarray:
    """Multilevel synthesis from ``(B, *spatial)`` bands; adjoint filters.

    Reconstruction multiplies by conjugate responses (the adjoint /
    matched filter, ``Functions/nd_dwt_3D.m:374``) and divides by ``2^d``
    per level iff not ``preserve_l2`` (``Functions/nd_dwt_3D.m:233-235``).
    """
    ndim = y.ndim - 1
    nb = 2**ndim
    axes = _spatial_axes(ndim)
    cdtype = resp[0].dtype
    Yf = jnp.fft.fftn(y.astype(cdtype), axes=axes)

    def synth(group_f: jnp.ndarray) -> jnp.ndarray:
        acc = None
        for b in range(nb):
            term = _apply_band(group_f[b], resp, b, conj=True)
            acc = term if acc is None else acc + term
        if not preserve_l2:
            acc = acc / nb
        return acc

    acc_f = synth(Yf[:nb])
    pos = nb
    for _ in range(1, level):
        group = jnp.concatenate([acc_f[None], Yf[pos : pos + nb - 1]], axis=0)
        acc_f = synth(group)
        pos += nb - 1
    x = jnp.fft.ifftn(acc_f, axes=axes)
    if real_out:
        x = x.real
    return x
