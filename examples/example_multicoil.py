"""Multi-coil batched transform demo — the workload shape of multi-channel
MRI (the reference's domain, but its MATLAB classes transform one array per
call; here the whole coil batch is one traced program via ``dec_batched``).
Uses the symlet family (``sym4`` — least-asymmetric Daubechies, a
capability superset of the reference's db table) and per-coil shrinkage.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import non_decimated_wavelets as nw
from non_decimated_wavelets.models import soft_threshold


def coil_images(n=64, coils=4, seed=0):
    """Synthetic multi-coil magnitude images: one phantom modulated by
    smooth coil-sensitivity profiles."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n - 0.5
    obj = ((xx**2 + yy**2) < 0.16).astype(np.float32)
    obj += 0.5 * ((np.abs(xx - 0.1) < 0.08) & (np.abs(yy) < 0.2))
    centers = rng.uniform(-0.5, 0.5, size=(coils, 2)).astype(np.float32)
    sens = np.exp(
        -((xx[None] - centers[:, :1, None]) ** 2
          + (yy[None] - centers[:, 1:, None]) ** 2) / 0.5
    ).astype(np.float32)
    return sens * obj[None]


def main():
    import jax.numpy as jnp

    x = coil_images()
    coils, n = x.shape[0], x.shape[1]
    plan = nw.NDDWT(wavelet="sym4", shape=(n, n), preserve_l2=True,
                    dtype=jnp.float32)

    y = plan.dec_batched(jnp.asarray(x), level=3)  # (coils, B, n, n)
    print(f"bands: {y.shape[1]} (batch of {coils} coils in one program)")
    ratio = float(jnp.linalg.norm(y) / jnp.linalg.norm(jnp.asarray(x)))
    print(f"energy ratio: {ratio:.6f}")

    xr = plan.rec_batched(y)
    err = float(jnp.max(jnp.abs(xr - jnp.asarray(x))))
    print(f"max recon error: {err:.3e}")

    # Per-coil detail shrinkage (band 0 = approximation, preserved)
    noisy = x + 0.1 * np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32
    )
    yn = plan.dec_batched(jnp.asarray(noisy), level=3)
    yn = jnp.concatenate(
        [yn[:, :1], soft_threshold(yn[:, 1:], 0.08)], axis=1
    )
    den = np.asarray(plan.rec_batched(yn))
    mse_noisy = float(np.mean((noisy - x) ** 2))
    mse_den = float(np.mean((den - x) ** 2))
    print(f"denoise MSE: {mse_noisy:.4f} -> {mse_den:.4f}")


if __name__ == "__main__":
    main()
