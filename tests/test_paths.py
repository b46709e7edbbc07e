"""The XLA compute paths (``'auto'`` and ``'fft'``) against the float64 NumPy
oracle over the shape x wavelet x level grids of the engine: small and
large, 1D-4D, mixed per-axis filters, long filters, the fused shrink
iterate, the split-complex entry points, bf16 and f64, and the gradient
rule (``jax.vjp`` of ``dec`` is ``rec`` for a tight frame).

Every comparison is against ``oracle.py`` (reference semantics), never one
engine path against another."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import non_decimated_wavelets as nw
from non_decimated_wavelets import oracle

PATHS = ["auto", "fft"]


def _gold(x, wv, level, pl2=False):
    """Oracle bands, band-first (float64, or complex128 for complex x)."""
    x = np.asarray(x)
    x = x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)
    return np.moveaxis(oracle.dec(x, wv, level, preserve_l2=pl2), -1, 0)


def _shrink(y, lam):
    """Soft-threshold the detail bands of band-first oracle bands."""
    mag = np.abs(y[1:])
    fac = np.maximum(mag - lam, 0.0) / np.maximum(mag, 1e-30)
    return np.concatenate([y[:1], y[1:] * fac], axis=0)


def _orec(y, wv, pl2=False):
    """Oracle synthesis from band-first bands."""
    y = np.asarray(y)
    y = y.astype(np.complex128 if np.iscomplexobj(y) else np.float64)
    return oracle.rec(np.moveaxis(y, 0, -1), wv, preserve_l2=pl2)


def _x(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


CASES = [
    ((32, 128), "db4", 2),
    ((32, 256), ("db2", "db6"), 1),
    ((16, 16, 128), ("db2", "db3", "db4"), 2),
    ((8, 8, 128), "db1", 3),
]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level", CASES)
def test_dec_matches_oracle(shape, wv, level, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    assert y.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level), atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level", CASES)
@pytest.mark.parametrize("pl2", [False, True])
def test_rec_roundtrip(shape, wv, level, pl2, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2,
                    dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = _gold(x, wv, level, pl2).astype(np.float32)
    xr = plan.rec(y, band_axis=0)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-4)


MULTI_CASES = [
    ((64, 128), "db2", 3, False),
    ((32, 16, 128), "db4", 3, True),
    ((16, 16, 256), ("db1", "db3", "db2"), 2, False),
    ((24, 8, 128), ("db6", "db2", "db4"), 4, True),
]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level,pl2", MULTI_CASES)
def test_multilevel_cascade(shape, wv, level, pl2, path, rng):
    """Deep cascades, both directions, including the fused detail shrink
    of ``dec_rec``."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32,
                    preserve_l2=pl2, path=path)
    x = _x(rng, shape)
    gold = _gold(x, wv, level, pl2)
    np.testing.assert_allclose(np.asarray(plan.dec(x, level, band_axis=0)),
                               gold, atol=1e-5)
    ys, _ = plan.dec_rec(x, level, threshold=0.1, band_axis=0)
    np.testing.assert_allclose(np.asarray(ys), _shrink(gold, 0.1), atol=1e-5)
    xr = plan.rec(gold.astype(np.float32), band_axis=0)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level",
    [
        ((1024,), "db4", 3),
        ((256,), "db2", 2),
        ((64, 128), ("db3", "db5"), 3),
        ((128, 256), "db1", 2),
    ],
)
def test_small_shapes_match_oracle(shape, wv, level, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level), atol=1e-5)
    xr = plan.rec(y, band_axis=0)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level",
    [
        ((32, 32, 128), "db8", 2),
        ((64, 64, 128), "db10", 1),
        ((32, 32, 128), ("db2", "db8", "db4"), 2),
    ],
)
def test_long_filters(shape, wv, level, path, rng):
    """Long and mixed filters: wide periodic wraps on every axis."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level), atol=2e-5)
    xr = plan.rec(y, band_axis=0)
    np.testing.assert_allclose(np.asarray(xr), x, atol=2e-4)


CASES_4D = [
    ((8, 8, 4, 32), "db2", 2),
    ((8, 16, 8, 16), ("db1", "db2", "db3", "db2"), 1),
    ((16, 8, 4, 32), "db1", 3),
]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level", CASES_4D)
def test_4d_dec_matches_oracle(shape, wv, level, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level), atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level", CASES_4D[:2])
@pytest.mark.parametrize("pl2", [False, True])
def test_4d_rec_roundtrip(shape, wv, level, pl2, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2,
                    dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    xr = plan.rec(_gold(x, wv, level, pl2).astype(np.float32), band_axis=0)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize(
    "shape,wv,level,lam",
    [
        ((1024,), "db4", 3, 0.0),
        ((1024,), "db4", 3, 0.1),
        ((64, 128), ("db3", "db5"), 2, 0.05),
    ],
)
def test_dec_rec_matches_composition(shape, wv, level, lam, pl2, path, rng):
    """``dec_rec`` == oracle dec -> detail shrink -> oracle rec."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2,
                    dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y, xr = plan.dec_rec(x, level, threshold=lam, band_axis=0)
    gold = _gold(x, wv, level, pl2)
    if lam:
        gold = _shrink(gold, lam)
    np.testing.assert_allclose(np.asarray(y), gold, atol=1e-5)
    np.testing.assert_allclose(np.asarray(xr), _orec(gold, wv, pl2),
                               atol=1e-4)


# The reference's own awkward small sizes (Test/nddwt2D_test.m:5), 1D-4D.
CASES_SMALL_ODD = [
    ((64, 64), "db2", 2),
    ((54,), "db4", 3),
    ((26, 26), ("db1", "db3"), 2),
    ((24, 18, 10), ("db2", "db3", "db2"), 2),
    ((264, 264), "db4", 1),
    ((14, 10, 6, 6), "db1", 2),
]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level", CASES_SMALL_ODD)
def test_small_odd_dec_matches_oracle(shape, wv, level, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    y = plan.dec(x, level, band_axis=0)
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level), atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape,wv,level", CASES_SMALL_ODD[:4])
@pytest.mark.parametrize("pl2", [False, True])
def test_small_odd_rec_roundtrip(shape, wv, level, pl2, path, rng):
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2,
                    dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    xr = plan.rec(_gold(x, wv, level, pl2).astype(np.float32), band_axis=0)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level",
    [((16, 128), "db3", 2), ((10, 6, 4, 6), "db2", 2)],
)
def test_vjp_of_dec_is_rec(shape, wv, level, path, rng):
    """Autodiff of the plain path: with ``preserve_l2`` the transform is a
    tight frame, so the vjp of ``dec`` is ``rec`` and the vjp of ``rec``
    is ``dec``."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=True,
                    dtype=jnp.float32, path=path)
    x = jnp.asarray(_x(rng, shape))
    w = jnp.asarray(_x(rng, (plan.num_bands(level),) + shape))
    _, vjp_dec = jax.vjp(lambda v: plan.dec(v, level, band_axis=0), x)
    np.testing.assert_allclose(np.asarray(vjp_dec(w)[0]),
                               _orec(w, wv, pl2=True), atol=1e-4)
    _, vjp_rec = jax.vjp(lambda v: plan.rec(v, band_axis=0), w)
    np.testing.assert_allclose(np.asarray(vjp_rec(x)[0]),
                               _gold(x, wv, level, pl2=True), atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level",
    [
        ((16, 16, 128), "db4", 2),
        ((64, 128), "db2", 2),
        ((30, 50), "db2", 2),
        ((16, 16, 16, 16), "db2", 2),
        ((41, 16, 10), "db2", 2),
        ((40, 40, 72), "db2", 2),
    ],
)
def test_bf16_roundtrip(shape, wv, level, path, rng):
    """bf16 storage, f32 taps and accumulation: the bands stay bf16 and
    the round trip holds to the f32-compute bound."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.bfloat16, path=path)
    assert plan.taps[0].dtype == np.float32
    x = jnp.asarray(_x(rng, shape), jnp.bfloat16)
    y = plan.dec(x, level, band_axis=0)
    assert y.dtype == jnp.bfloat16
    xr = plan.rec(y, band_axis=0)
    assert xr.dtype == jnp.bfloat16
    err = float(jnp.max(jnp.abs(xr.astype(jnp.float32)
                                - x.astype(jnp.float32))))
    assert err < 0.05


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "shape,wv,level,pl2",
    [
        ((16, 16, 128), "db4", 2, False),
        ((32, 256), "db6", 3, True),
        ((16, 16, 128), ("db2", "db3", "db4"), 2, False),
    ],
)
def test_f64_matches_oracle(shape, wv, level, pl2, path, rng):
    """Native float64 holds the <=1e-12 contract on both paths."""
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float64,
                    preserve_l2=pl2, path=path)
    x = rng.standard_normal(shape)
    y = plan.dec(x, level, band_axis=0)
    assert y.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(y), _gold(x, wv, level, pl2),
                               atol=1e-12)
    xr = plan.rec(y, band_axis=0)
    assert xr.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-12)


@pytest.mark.parametrize("path", PATHS)
def test_batched_matches_oracle(path, rng):
    shape = (16, 128)
    plan = nw.NDDWT(wavelet="db2", shape=shape, dtype=jnp.float32, path=path)
    xb = _x(rng, (3,) + shape)
    yb = plan.dec_batched(xb, 2)
    for i in range(3):
        np.testing.assert_allclose(np.asarray(yb[i]), _gold(xb[i], "db2", 2),
                                   atol=1e-5)
    np.testing.assert_allclose(np.asarray(plan.rec_batched(yb)), xb,
                               atol=1e-4)


class TestSplit:
    """Split re/im entry points: both components of a complex array as a
    leading pair axis of a real array."""

    @pytest.mark.parametrize("path", PATHS)
    @pytest.mark.parametrize("shape,wv,level", [
        ((54,), "db4", 3),
        ((24, 36), ("db2", "db3"), 2),
        ((10, 12, 14), "db2", 2),
    ])
    def test_dec_rec_match_complex_oracle(self, shape, wv, level, path, rng):
        plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32,
                        path=path)
        xc = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        pair = np.stack([xc.real, xc.imag]).astype(np.float32)
        y = plan.dec_split(pair, level)
        gold = _gold(pair[0] + 1j * pair[1].astype(np.float64), wv, level)
        np.testing.assert_allclose(np.asarray(y[0]), gold.real, atol=1e-4)
        np.testing.assert_allclose(np.asarray(y[1]), gold.imag, atol=1e-4)
        xr = plan.rec_split(y)
        np.testing.assert_allclose(np.asarray(xr), pair, atol=1e-4)

    @pytest.mark.parametrize("path", PATHS)
    def test_magnitude_shrink(self, path, rng):
        """The split iterate applies the COMPLEX soft-threshold (joint re/im
        magnitude) to the detail bands."""
        shape, wv, level, lam = (20, 24), "db2", 2, 0.35
        plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32,
                        path=path)
        pair = _x(rng, (2,) + shape)
        y, xr = plan.dec_rec_split(pair, level, threshold=lam)
        gold = _shrink(_gold(pair[0] + 1j * pair[1].astype(np.float64), wv,
                             level), lam)
        np.testing.assert_allclose(np.asarray(y[0]) + 1j * np.asarray(y[1]),
                                   gold, atol=1e-4)
        xref = _orec(gold, wv)
        np.testing.assert_allclose(np.asarray(xr[0]) + 1j * np.asarray(xr[1]),
                                   xref, atol=1e-4)

    @pytest.mark.parametrize("path", PATHS)
    def test_zero_threshold_is_identity(self, path, rng):
        shape = (18, 22)
        plan = nw.NDDWT(wavelet="db3", shape=shape, dtype=jnp.float32,
                        path=path)
        pair = _x(rng, (2,) + shape)
        y, xr = plan.dec_rec_split(pair, 2)
        assert y.shape == (2, plan.num_bands(2)) + shape
        np.testing.assert_allclose(np.asarray(xr), pair, atol=1e-4)


@pytest.mark.parametrize("path", PATHS)
def test_dec_rec_n_matches_sequential(path, rng):
    """``dec_rec_n`` with a varying schedule == the explicit sequence of
    oracle dec -> detail shrink -> oracle rec sweeps."""
    shape, wv, level = (22, 30), "db2", 2
    lams = (0.3, 0.12, 0.05)
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    x = _x(rng, shape)
    xr = plan.dec_rec_n(x, level, lams)
    ref = x.astype(np.float64)
    for lam in lams:
        ref = _orec(_shrink(_gold(ref, wv, level), lam), wv)
    np.testing.assert_allclose(np.asarray(xr), ref, atol=1e-4)


def test_dec_rec_n_validation(rng):
    plan = nw.NDDWT(wavelet="db3", shape=(16, 20), dtype=jnp.float32)
    x = _x(rng, (16, 20))
    with pytest.raises(ValueError, match="at least one"):
        plan.dec_rec_n(x, 2, [])
    with pytest.raises(ValueError, match="real-only"):
        plan.dec_rec_n(x + 1j * x, 2, [0.1])


def _fista_reference(b, mask, wv, lam, level, iters, step=1.0):
    """FISTA (image-domain masked data term) composed from the oracle in
    float64: the loop ``models.fista_inpaint`` must reproduce."""
    x = mask * b
    z, t = x, 1.0
    for _ in range(iters):
        v = z - step * (mask * (mask * z - b))
        x_new = _orec(_shrink(_gold(v, wv, level, True), lam * step), wv,
                      True)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        z = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


@pytest.mark.parametrize("path", PATHS)
def test_fista_inpaint_matches_composition(path, rng):
    from non_decimated_wavelets.models import fista_inpaint

    n, lam, iters = 40, 0.05, 12
    x0 = rng.standard_normal((n, n))
    mask = (rng.random((n, n)) < 0.6).astype(np.float64)
    b = mask * x0
    plan = nw.NDDWT(wavelet="db2", shape=(n, n), preserve_l2=True,
                    dtype=jnp.float32, path=path)
    got = fista_inpaint(plan, jnp.asarray(b, jnp.float32),
                        jnp.asarray(mask, jnp.float32), lam, level=2,
                        iters=iters)
    ref = _fista_reference(b, mask, "db2", lam, 2, iters)
    np.testing.assert_allclose(np.asarray(got), ref, atol=2e-3)


@pytest.mark.parametrize("path", PATHS)
def test_fista_inpaint_split_matches_complex_composition(path, rng):
    """The split-complex solve == the complex FISTA composed from the
    oracle (real filters + joint-magnitude shrink)."""
    from non_decimated_wavelets.models import fista_inpaint_split

    n, lam, iters = 32, 0.04, 10
    xc = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    mask = (rng.random((n, n)) < 0.6).astype(np.float64)
    b = mask * xc
    plan = nw.NDDWT(wavelet="db2", shape=(n, n), preserve_l2=True,
                    dtype=jnp.float32, path=path)
    pair = jnp.asarray(np.stack([b.real, b.imag]), jnp.float32)
    got = fista_inpaint_split(plan, pair, jnp.asarray(mask, jnp.float32), lam,
                              level=2, iters=iters)
    ref = _fista_reference(b, mask, "db2", lam, 2, iters)
    np.testing.assert_allclose(np.asarray(got[0]) + 1j * np.asarray(got[1]),
                               ref, atol=2e-3)
