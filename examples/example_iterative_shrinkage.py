"""Iterated shrinkage with a decreasing threshold schedule — the
multi-sweep pattern the reference's iterative users run by hand
(``README.md:2``), driven through ``NDDWT.dec_rec_n``: all N
dec -> soft-threshold -> rec sweeps run as one ``lax.scan``, so a jitted
caller compiles one sweep and dispatches the chain once."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import non_decimated_wavelets as nw


def phantom(n=96):
    yy, xx = np.mgrid[0:n, 0:n] / n - 0.5
    img = ((xx**2 + yy**2) < 0.16).astype(np.float32)
    img += 0.5 * ((np.abs(xx - 0.1) < 0.08) & (np.abs(yy) < 0.2))
    return img


def main():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    img = phantom()
    noisy = img + 0.25 * rng.standard_normal(img.shape).astype(np.float32)

    plan = nw.NDDWT(wavelet="db2", shape=img.shape, preserve_l2=True,
                    dtype=jnp.float32)
    # Geometrically decreasing schedule: aggressive early sweeps remove
    # noise, later gentle sweeps restore structure the first pass shrank.
    schedule = [0.5 * (0.6**k) for k in range(6)]
    out = np.asarray(plan.dec_rec_n(jnp.asarray(noisy), 2, schedule))

    def psnr(a):
        return 10 * np.log10(img.max() ** 2 / np.mean((a - img) ** 2))

    print(f"bands: {plan.num_bands(2)}; "
          f"schedule: {[round(s, 3) for s in schedule]}")
    print(f"noisy PSNR:    {psnr(noisy):.2f} dB")
    print(f"denoised PSNR: {psnr(out):.2f} dB")
    assert psnr(out) > psnr(noisy) + 3


if __name__ == "__main__":
    main()
