"""3D NDDWT demo — mirrors ``example_nd_dwt_3D.m`` (random volume,
three different wavelets, energy + recon error)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import non_decimated_wavelets as nw


def main():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 64, 40))
    t = nw.nd_dwt_3D(("db1", "db3", "db2"), x.shape, pres_l2_norm=True, precision="single")
    y = t.dec(x, 2)
    xr = np.asarray(t.rec(y))
    print(f"bands: {np.asarray(y).shape[-1]}")
    print(f"energy ratio: {np.linalg.norm(np.asarray(y))/np.linalg.norm(x):.6f}")
    print(f"max recon error: {np.max(np.abs(xr - x)):.3e}")


if __name__ == "__main__":
    main()
