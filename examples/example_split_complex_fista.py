"""Split-complex CS reconstruction demo — complex MRI data carried as a
(2, n, n) re/im pair. The real filters transform the components
independently (numerically identical to the reference's native complex
handling, ``Functions/nd_dwt_3D.m:150-154``), and the sparsity prox is the
complex-l1 joint-magnitude shrink, applied by ``plan.dec_rec_split``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import non_decimated_wavelets as nw
from non_decimated_wavelets.models import fista_inpaint_split


def phantom(n=64):
    """Piecewise-constant complex phantom: magnitude phantom with a smooth
    spatial phase ramp (the usual shape of coil-combined MRI data)."""
    yy, xx = np.mgrid[0:n, 0:n] / n - 0.5
    mag = ((xx**2 + yy**2) < 0.16).astype(np.float32)
    mag += 0.5 * ((np.abs(xx - 0.1) < 0.08) & (np.abs(yy) < 0.2))
    phase = np.exp(1j * 2 * np.pi * (0.3 * xx + 0.2 * yy)).astype(np.complex64)
    return mag * phase


def main():
    import jax.numpy as jnp

    n = 64
    xc = phantom(n)
    rng = np.random.default_rng(0)
    mask = (rng.random((n, n)) < 0.45).astype(np.float32)
    b = mask * (xc + 0.03 * (rng.standard_normal((n, n))
                             + 1j * rng.standard_normal((n, n))).astype(
                                 np.complex64))

    plan = nw.NDDWT(wavelet="db2", shape=(n, n), preserve_l2=True,
                    dtype=jnp.float32)
    print(f"bands: {plan.num_bands(2)} (split pair, no complex op executes)")

    pair = jnp.asarray(np.stack([b.real, b.imag]))
    out = np.asarray(
        fista_inpaint_split(plan, pair, jnp.asarray(mask), lam=0.01,
                            level=2, iters=40)
    )
    rec = out[0] + 1j * out[1]

    err_zf = np.linalg.norm(b - xc) / np.linalg.norm(xc)
    err_rec = np.linalg.norm(rec - xc) / np.linalg.norm(xc)
    print(f"relative error: masked {err_zf:.3f} -> FISTA {err_rec:.3f}")
    assert err_rec < 0.5 * err_zf


if __name__ == "__main__":
    main()
