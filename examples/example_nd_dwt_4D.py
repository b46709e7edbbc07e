"""4D NDDWT demo — mirrors ``example_nd_dwt_4D.m`` plus the Haar direct
class (``harr_nddwt_4D``) the reference ships for dynamic volumes."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import non_decimated_wavelets as nw


def main():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 32, 16, 8))
    t = nw.nd_dwt_4D("db2", x.shape, pres_l2_norm=True, precision="single")
    y = t.dec(x, 2)
    xr = np.asarray(t.rec(y))
    print(f"db2: bands {np.asarray(y).shape[-1]}, "
          f"energy ratio {np.linalg.norm(np.asarray(y))/np.linalg.norm(x):.6f}, "
          f"recon err {np.max(np.abs(xr - x)):.3e}")

    th = nw.harr_nddwt_4D(sizes=x.shape, pres_l2_norm=True, precision="single")
    yh = th.dec(x, 1)
    xh = np.asarray(th.rec(yh))
    print(f"haar: bands {np.asarray(yh).shape[-1]}, recon err {np.max(np.abs(xh - x)):.3e}")


if __name__ == "__main__":
    main()
