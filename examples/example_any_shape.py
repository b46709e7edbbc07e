"""Any-shape, any-precision transforms.

The reference runs any size on every backend (its own tests use
[164,64,40] and [64,64,20,10] — ``Test/nddwt3D_test.m:5``,
``Test/nddwt4D_test.m:5``). So does this framework: the XLA paths take
any shape, in float32, bfloat16 or float64, on the GPU and the CPU alike.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

import non_decimated_wavelets as nw


def main():
    rng = np.random.default_rng(0)

    # The reference's own awkward 3D size, mixed per-axis wavelets.
    shape = (164, 64, 40)
    plan = nw.NDDWT(wavelet=("db1", "db3", "db9"), shape=shape)
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    y = plan.dec(x, 2, band_axis=0)
    xr = plan.rec(y, band_axis=0)
    print(f"{shape} mixed db1/db3/db9: bands {y.shape[0]}, "
          f"recon err {float(jnp.max(jnp.abs(xr - x))):.2e}")

    # Odd-frame 4D (the dynamic-MRI shape class).
    shape4 = (36, 36, 24, 10)
    plan4 = nw.NDDWT(wavelet="db2", shape=shape4)
    x4 = jnp.asarray(rng.standard_normal(shape4), jnp.float32)
    y4 = plan4.dec(x4, 2, band_axis=0)
    xr4 = plan4.rec(y4, band_axis=0)
    print(f"{shape4} db2: bands {y4.shape[0]}, "
          f"recon err {float(jnp.max(jnp.abs(xr4 - x4))):.2e}")

    # float64: <=1e-12 reconstruction.
    shape64 = (64, 64, 128)
    plan64 = nw.NDDWT(wavelet="db4", shape=shape64, dtype="double")
    x64 = jnp.asarray(rng.standard_normal(shape64))
    y64 = plan64.dec(x64, 3, band_axis=0)
    xr64 = plan64.rec(y64, band_axis=0)
    err64 = float(jnp.max(jnp.abs(xr64 - x64)))
    print(f"{shape64} float64: recon err {err64:.2e} (target <= 1e-12)")
    assert err64 <= 1e-12


if __name__ == "__main__":
    main()
