"""1D NDDWT demo — mirrors the reference's ``example_nd_dwt_1D.m``:
construct -> dec -> rec, print wavelet/signal-domain energy and the
reconstruction error. The reference uses MATLAB's ``noisbloc`` fixture; here
a synthetic blocky signal plus noise stands in."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import non_decimated_wavelets as nw


def noisbloc(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n, endpoint=False)
    blocks = np.zeros(n)
    for pos, amp in [(0.1, 4), (0.13, -5), (0.15, 3), (0.23, -4), (0.25, 5),
                     (0.4, -4.2), (0.44, 2.1), (0.65, 4.3), (0.76, -3.1), (0.78, 2.1)]:
        blocks += amp * (1 + np.sign(t - pos)) / 2
    return blocks + 0.5 * rng.standard_normal(n)


def main():
    x = noisbloc()
    t = nw.nd_dwt_1D("db4", len(x), pres_l2_norm=True, precision="single")
    y = t.dec(x, 3)
    xr = np.asarray(t.rec(y))
    print(f"bands: {np.asarray(y).shape[-1]}")
    print(f"signal energy:  {np.linalg.norm(x)**2:.6f}")
    print(f"wavelet energy: {np.linalg.norm(np.asarray(y))**2:.6f}")
    print(f"max recon error: {np.max(np.abs(xr - x)):.3e}")


if __name__ == "__main__":
    main()
