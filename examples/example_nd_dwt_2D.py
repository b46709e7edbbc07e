"""2D NDDWT demo — mirrors ``example_nd_dwt_2D.m`` (which uses
``cameraman.tif``); here a synthetic phantom image. Adds the denoising
application the transform exists for."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import non_decimated_wavelets as nw
from non_decimated_wavelets.models import denoise


def phantom(n=256):
    yy, xx = np.mgrid[0:n, 0:n] / n - 0.5
    img = ((xx**2 + yy**2) < 0.16).astype(float)
    img += 0.5 * ((np.abs(xx - 0.1) < 0.08) & (np.abs(yy) < 0.2))
    return img


def main():
    img = phantom()
    t = nw.nd_dwt_2D(("db1", "db3"), img.shape, pres_l2_norm=True, precision="single")
    y = t.dec(img, 3)
    rec = np.asarray(t.rec(y))
    print(f"bands: {np.asarray(y).shape[-1]}")
    print(f"energy ratio: {np.linalg.norm(np.asarray(y))/np.linalg.norm(img):.6f}")
    print(f"max recon error: {np.max(np.abs(rec - img)):.3e}")

    rng = np.random.default_rng(0)
    noisy = img + 0.2 * rng.standard_normal(img.shape)
    plan = nw.NDDWT(wavelet="db2", shape=img.shape, preserve_l2=True)
    den = np.asarray(denoise(plan, noisy.astype(np.float32), 3, lam=0.15))
    print(f"noisy PSNR:    {-10*np.log10(np.mean((noisy-img)**2)):.2f} dB")
    print(f"denoised PSNR: {-10*np.log10(np.mean((den-img)**2)):.2f} dB")


if __name__ == "__main__":
    main()
