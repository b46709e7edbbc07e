"""Arbitrary shapes on the XLA paths, against the float64 NumPy oracle.

The reference runs any size on every backend; its own test configs use
deliberately awkward extents (``[164,64,40]``, ``Test/nddwt3D_test.m:5``;
``[64,64,20,10]``, ``Test/nddwt4D_test.m:5``). These sweeps cover odd and
prime extents, odd leading and trailing axes, long 1D signals and odd 4D
volumes, through ``'auto'`` and ``'fft'``."""

import jax.numpy as jnp
import numpy as np
import pytest

import non_decimated_wavelets as nw
from non_decimated_wavelets import oracle

PATHS = ["auto", "fft"]


def _gold(x, wv, level, pl2=False):
    return np.moveaxis(
        oracle.dec(np.asarray(x, np.float64), wv, level, preserve_l2=pl2),
        -1, 0,
    )


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


CASES = [
    ((41, 16, 10), "db2", 2),
    ((19, 257), "db4", 1),
    ((20, 12, 10), ("db1", "db2", "db3"), 2),
    ((10, 6, 4, 6), "db2", 2),
]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level", CASES)
def test_dec_matches_oracle(shape, wv, level, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level), atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level", CASES)
@pytest.mark.parametrize("pl2", [False, True])
def test_rec_roundtrip(shape, wv, level, pl2, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2,
                    dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    xr = plan.rec(_gold(x, wv, level, pl2).astype(np.float32), band_axis=0)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level",
    [
        ((164, 64, 40), ("db1", "db3", "db9"), 2),
        ((64, 64, 20, 10), "db2", 2),
    ],
)
def test_reference_odd_configs(shape, wv, level, path, rng):
    """The reference's own awkward test sizes, in the reference layout."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level)
    np.testing.assert_allclose(
        np.asarray(y), oracle.dec(x.astype(np.float64), wv, level), atol=2e-5
    )
    np.testing.assert_allclose(np.asarray(plan.rec(y)), x, atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape", [(41, 16, 10), (40, 40, 72)])
def test_shrink_matches_oracle(shape, path, rng):
    """``dec_rec``'s detail shrink on odd shapes == oracle bands shrunk."""
    lam = 0.1
    plan = nw.NDDWT(wavelet="db2", shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y, _ = plan.dec_rec(x, 2, threshold=lam, band_axis=0)
    gold = _gold(x, "db2", 2)
    mag = np.abs(gold[1:])
    gold[1:] *= np.maximum(mag - lam, 0.0) / np.maximum(mag, 1e-30)
    np.testing.assert_allclose(np.asarray(y), gold, atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
def test_adjointness(path, rng):
    """<dec(x), y> == <x, rec(y)> for the tight frame on an odd shape."""
    shape = (20, 12, 10)
    plan = nw.NDDWT(wavelet="db2", shape=shape, preserve_l2=True,
                    dtype=jnp.float64, path=path)
    x = rng.standard_normal(shape)
    yr = rng.standard_normal((plan.num_bands(2),) + shape)
    lhs = float(jnp.vdot(plan.dec(x, 2, band_axis=0), yr))
    rhs = float(jnp.vdot(x, plan.rec(yr, band_axis=0)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level",
    [
        ((23, 11), "db3", 2),
        ((9, 7, 26), "db1", 2),
        ((17, 5, 6), "db2", 1),
        ((7, 5, 3, 4), "db1", 2),
    ],
)
def test_random_odd_shapes(shape, wv, level, path, rng):
    """Prime and tiny extents, ragged in every axis."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level), atol=1e-5)
    np.testing.assert_allclose(np.asarray(plan.rec(y, band_axis=0)), x,
                               atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level,pl2",
    [
        ((40, 40, 72), "db4", 2, False),
        ((40, 40, 72), ("db2", "db3", "db4"), 2, True),
        ((70, 200), "db2", 3, False),
        ((34, 32, 128), "db2", 2, False),
    ],
)
def test_larger_odd_shapes(shape, wv, level, pl2, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32,
                    preserve_l2=pl2, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level, pl2),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(plan.rec(y, band_axis=0)), x,
                               atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level,pl2",
    [
        ((20, 20, 12, 10), "db2", 2, False),
        ((20, 20, 12, 10), ("db2", "db2", "db3", "db1"), 2, True),
    ],
)
def test_odd_4d(shape, wv, level, pl2, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32,
                    preserve_l2=pl2, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level, pl2),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(plan.rec(y, band_axis=0)), x,
                               atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "N,wv,level,pl2",
    [
        (5000, "db4", 3, False),
        (4096, "db2", 2, True),
        (130001, "db6", 3, False),
    ],
)
def test_long_1d(N, wv, level, pl2, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=(N,), dtype=jnp.float32,
                    preserve_l2=pl2, path=path)
    x = _x(rng, (N,))
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level, pl2),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(plan.rec(y, band_axis=0)), x,
                               atol=1e-4)
