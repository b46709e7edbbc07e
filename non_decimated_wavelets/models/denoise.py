"""Wavelet-shrinkage denoising on the non-decimated transform.

The canonical application of a shift-invariant wavelet transform (the
reference ships the transform only; its examples stop at round-trip demos,
``example_nd_dwt_2D.m``). Cycle-spinning denoising is what the redundancy is
*for*: threshold the detail bands, reconstruct, and the shift-invariance
removes the blocking artifacts a decimated DWT would leave.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def soft_threshold_mag_pair(y_pair, lam):
    """Joint re/im magnitude soft-threshold of the detail bands of a
    split-complex band-first array ``(2, B, *spatial)`` — the prox of the
    COMPLEX l1 norm, the reference's MRI contract
    (``Functions/nd_dwt_1D.m:57-61``). The approximation band (band 0)
    passes through. One home for the three call sites (plan, models,
    sharded) that must stay numerically identical."""
    mag = jnp.sqrt(y_pair[0, 1:] ** 2 + y_pair[1, 1:] ** 2)
    fac = (jnp.maximum(mag - lam, 0.0) / jnp.maximum(mag, 1e-30)).astype(
        y_pair.dtype
    )
    return jnp.concatenate(
        [y_pair[:, :1], y_pair[:, 1:] * fac[None]], axis=1
    )


def soft_threshold(y: jnp.ndarray, lam) -> jnp.ndarray:
    """sign(y) * max(|y| - lam, 0); complex-safe (phase-preserving)."""
    mag = jnp.abs(y)
    scale = jnp.maximum(mag - lam, 0.0) / jnp.maximum(mag, 1e-30)
    return y * scale


def shrink_details(y: jnp.ndarray, lam) -> jnp.ndarray:
    """Soft-threshold the detail bands of a band-first ``(B, ...)`` array;
    the approximation band (band 0) carries the low-frequency content the
    l1 penalty should not shrink. Keeps ``y``'s dtype for any ``lam``."""
    return jnp.concatenate(
        [y[:1], soft_threshold(y[1:], lam).astype(y.dtype)], axis=0
    )


def hard_threshold(y: jnp.ndarray, lam) -> jnp.ndarray:
    return jnp.where(jnp.abs(y) >= lam, y, 0.0)


def denoise(plan, x, level: int, lam, mode: str = "soft"):
    """Threshold detail bands (keep the approximation) and reconstruct.

    ``plan`` is an ``NDDWT`` (band-last public layout is used here). Soft
    mode with a static ``lam`` routes through ``plan.dec_rec``.
    """
    if mode == "soft" and not hasattr(lam, "shape"):
        _, rec = plan.dec_rec(x, level, threshold=float(lam))
        return rec
    thr = {"soft": soft_threshold, "hard": hard_threshold}[mode]
    y = plan.dec(x, level)
    approx = y[..., :1]
    details = thr(y[..., 1:], lam)
    return plan.rec(jnp.concatenate([approx, details], axis=-1))
