"""JAX engine vs golden oracle: cross-path agreement (the analogue of the
reference's mat-vs-mex tier, ``mex/mex_test.m``), dtype sweeps, functional
transforms (jit/vmap/grad) the reference could never offer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import non_decimated_wavelets as nw
from non_decimated_wavelets import oracle

CASES = [
    ((54,), "db4", 3),
    ((26, 22), ("db2", "db3"), 3),
    ((16, 14, 10), ("db1", "db4", "db2"), 2),
    ((8, 12, 10, 6), "db2", 2),
]


@pytest.mark.parametrize("shape,wv,lvl", CASES)
@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("path", ["fft", "direct"])
def test_vs_oracle_f64(shape, wv, lvl, pl2, path, rng):
    x = rng.standard_normal(shape)
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype="double", path=path)
    y = np.asarray(plan.dec(x, lvl))
    np.testing.assert_allclose(
        y, oracle.dec(x, wv, lvl, preserve_l2=pl2), atol=1e-12
    )
    xr = np.asarray(plan.rec(y))
    assert np.max(np.abs(xr - x)) < 1e-12


@pytest.mark.parametrize("path", ["fft", "direct"])
def test_complex_vs_oracle(path, rng):
    shape, wv, lvl = (20, 18), ("db3", "db2"), 2
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype="double", path=path)
    y = np.asarray(plan.dec(x, lvl))
    assert np.iscomplexobj(y)
    np.testing.assert_allclose(y, oracle.dec(x, wv, lvl), atol=1e-12)
    assert np.max(np.abs(np.asarray(plan.rec(y)) - x)) < 1e-12


@pytest.mark.parametrize("path", ["fft", "direct"])
def test_f32_roundtrip(path, rng):
    shape = (32, 32)
    x = rng.standard_normal(shape).astype(np.float32)
    plan = nw.NDDWT(wavelet="db4", shape=shape, dtype="single", path=path)
    y = plan.dec(x, 3)
    assert y.dtype == jnp.float32
    xr = np.asarray(plan.rec(y))
    assert np.max(np.abs(xr - x)) < 5e-5


def test_band_first_layout(rng):
    shape = (16, 16)
    x = rng.standard_normal(shape)
    plan = nw.NDDWT(wavelet="db2", shape=shape, dtype="double")
    y_last = np.asarray(plan.dec(x, 2, band_axis=-1))
    y_first = np.asarray(plan.dec(x, 2, band_axis=0))
    np.testing.assert_allclose(np.moveaxis(y_first, 0, -1), y_last, atol=0)
    xr = np.asarray(plan.rec(y_first, band_axis=0))
    assert np.max(np.abs(xr - x)) < 1e-12


def test_vmap_batches(rng):
    """The transform is vmap-able — the capability the reference's per-call
    MATLAB loops could not express."""
    shape = (16, 12)
    xb = rng.standard_normal((5,) + shape)
    plan = nw.NDDWT(wavelet="db2", shape=shape, dtype="double", path="direct")
    yb = jax.vmap(lambda x: plan.dec(x, 2))(jnp.asarray(xb))
    for i in range(5):
        np.testing.assert_allclose(
            np.asarray(yb[i]), oracle.dec(xb[i], "db2", 2), atol=1e-12
        )


def test_grad_flows(rng):
    """dec/rec are linear; grad of a scalar loss must flow and equal the
    adjoint-transform image (preserve_l2 => rec is the exact adjoint)."""
    shape = (12, 10)
    x = jnp.asarray(rng.standard_normal(shape))
    plan = nw.NDDWT(wavelet="db2", shape=shape, preserve_l2=True, dtype="double")
    w = jnp.asarray(rng.standard_normal(shape + (plan.num_bands(2),)))

    def loss(x):
        return jnp.vdot(plan.dec(x, 2), w).real

    g = jax.grad(loss)(x)
    expected = plan.rec(w)
    np.testing.assert_allclose(np.asarray(g), np.asarray(expected), atol=1e-10)


def test_plan_validation():
    with pytest.raises(ValueError):
        nw.NDDWT(wavelet="db4", shape=(5,), dtype="double")  # filter > axis
    with pytest.raises(ValueError):
        nw.NDDWT(wavelet="db4", shape=(16,), path="bogus")
    with pytest.raises(ValueError):
        nw.NDDWT(wavelet=("db1", "db2"), shape=(16,))
    plan = nw.NDDWT(wavelet="db2", shape=(16, 16), dtype="double")
    with pytest.raises(ValueError):
        plan.dec(np.zeros((8, 8)), 1)  # shape mismatch
    with pytest.raises(ValueError):
        plan.dec(np.zeros((16, 16)), 0)  # bad level
    with pytest.raises(ValueError):
        plan.rec(np.zeros((16, 16, 9)))  # invalid band count


def test_dec_split_matches_complex(rng):
    """Split re/im transforms are numerically identical to the complex path
    (real filters act on re/im independently)."""
    shape = (16, 14)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    plan = nw.NDDWT(wavelet="db3", shape=shape, dtype="double", path="direct")
    pair = np.stack([x.real, x.imag])
    y_split = np.asarray(plan.dec_split(pair, 2))
    y_c = np.asarray(plan.dec(x, 2, band_axis=0))
    np.testing.assert_allclose(y_split[0] + 1j * y_split[1], y_c, atol=1e-12)
    x_back = np.asarray(plan.rec_split(y_split))
    np.testing.assert_allclose(x_back[0] + 1j * x_back[1], x, atol=1e-12)


def test_split_validation():
    plan = nw.NDDWT(wavelet="db2", shape=(16, 16), dtype="double")
    with pytest.raises(ValueError):
        plan.dec_split(np.zeros((3, 16, 16)), 1)
    with pytest.raises(ValueError):
        plan.rec_split(np.zeros((16, 16, 4)))


def test_fista_inpaint(rng):
    from non_decimated_wavelets.models import fista_inpaint

    n = 32
    img = np.zeros((n, n))
    img[8:24, 10:20] = 1.0
    mask = (rng.random((n, n)) < 0.6).astype(np.float64)
    b = jnp.asarray(mask * img)
    plan = nw.NDDWT(wavelet="db1", shape=(n, n), preserve_l2=True, dtype="double")
    x = np.asarray(fista_inpaint(plan, b, jnp.asarray(mask), lam=2e-3, level=2, iters=60))
    masked_err = np.linalg.norm(mask * img - img)
    assert np.linalg.norm(x - img) < 0.6 * masked_err


def test_bfloat16_roundtrip(rng):
    """bfloat16 storage (half the HBM traffic) with tolerances to match."""
    shape = (32, 32)
    x = rng.standard_normal(shape).astype(np.float32)
    plan = nw.NDDWT(wavelet="db2", shape=shape, dtype="bf16", path="direct")
    y = plan.dec(jnp.asarray(x, jnp.bfloat16), 2)
    assert y.dtype == jnp.bfloat16
    xr = np.asarray(plan.rec(y), dtype=np.float32)
    assert np.max(np.abs(xr - x)) < 0.15  # bf16 has ~3 decimal digits


def test_5d_superset(rng):
    """The engine is dimension-generic — 5D works (the reference stops at
    4D); oracle and direct path agree."""
    shape = (6, 6, 4, 4, 4)
    x = rng.standard_normal(shape)
    plan = nw.NDDWT(wavelet="db1", shape=shape, dtype="double", path="direct")
    y = np.asarray(plan.dec(x, 2))
    assert y.shape == shape + (32 + 31,)
    np.testing.assert_allclose(y, oracle.dec(x, "db1", 2), atol=1e-12)
    assert np.max(np.abs(np.asarray(plan.rec(y)) - x)) < 1e-12


def test_db12_superset(rng):
    """Wavelets beyond the reference's db10 table work (generated taps)."""
    x = rng.standard_normal(64)
    plan = nw.NDDWT(wavelet="db12", shape=(64,), preserve_l2=True, dtype="double")
    y = plan.dec(x, 2)
    assert abs(np.linalg.norm(np.asarray(y)) / np.linalg.norm(x) - 1) < 1e-12
    assert np.max(np.abs(np.asarray(plan.rec(y)) - x)) < 1e-12


def test_bfloat16_roundtrip_band_axis(rng):
    """bf16 plans work end-to-end (loose tolerance; accelerator dtype)."""
    import jax.numpy as jnp

    plan = nw.NDDWT(wavelet="db2", shape=(32, 32), dtype="bf16")
    assert plan.real_dtype == jnp.dtype(jnp.bfloat16)
    x = rng.standard_normal((32, 32)).astype(np.float32)
    y = plan.dec(jnp.asarray(x, jnp.bfloat16), 2, band_axis=0)
    assert y.dtype == jnp.bfloat16
    xr = plan.rec(y, band_axis=0)
    assert np.max(np.abs(np.asarray(xr, np.float32) - x)) < 0.15


def test_batched_matches_per_item(rng):
    """dec_batched/rec_batched == stacked per-item transforms (multi-coil
    style batches; the reference can only loop per array)."""
    import jax.numpy as jnp

    shape = (16, 24)
    N, level = 3, 2
    x = rng.standard_normal((N,) + shape)
    for path in ("direct", "fft"):
        plan = nw.NDDWT(wavelet="db3", shape=shape, dtype="double", path=path)
        yb = np.asarray(plan.dec_batched(x, level))
        for i in range(N):
            yi = np.asarray(plan.dec(x[i], level, band_axis=0))
            np.testing.assert_allclose(yb[i], yi, atol=1e-12)
        xr = np.asarray(plan.rec_batched(jnp.asarray(yb)))
        np.testing.assert_allclose(xr, x, atol=1e-12)


def test_batched_complex_and_errors(rng):
    shape = (8, 16)
    plan = nw.NDDWT(wavelet="db2", shape=shape, dtype="double", path="fft")
    xc = rng.standard_normal((2,) + shape) + 1j * rng.standard_normal((2,) + shape)
    y = plan.dec_batched(xc, 2)
    xr = np.asarray(plan.rec_batched(y))
    np.testing.assert_allclose(xr, xc, atol=1e-12)
    with pytest.raises(ValueError, match="batch"):
        plan.dec_batched(rng.standard_normal(shape), 2)  # missing batch dim


def test_bf16_fft_path_keeps_dtype(rng):
    """The FFT path computes in c64 (.real is f32); a bf16 plan must still
    return bf16 arrays (review r2 finding)."""
    import jax.numpy as jnp

    plan = nw.NDDWT(wavelet="db8", shape=(256,), dtype="bf16", path="fft")
    x = jnp.asarray(rng.standard_normal(256).astype(np.float32), jnp.bfloat16)
    y = plan.dec(x, 2, band_axis=0)
    assert y.dtype == jnp.bfloat16
    xr = plan.rec(y, band_axis=0)
    assert xr.dtype == jnp.bfloat16


def test_split_honors_fft_path(rng):
    """dec_split/rec_split run the FFT path per re/im component when the
    plan requests it (no silent direct-path substitution)."""
    shape = (16, 14)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    plan = nw.NDDWT(wavelet="db3", shape=shape, dtype="double", path="fft")
    pair = np.stack([x.real, x.imag])
    y_split = np.asarray(plan.dec_split(pair, 2))
    y_c = np.asarray(plan.dec(x, 2, band_axis=0))
    np.testing.assert_allclose(y_split[0] + 1j * y_split[1], y_c, atol=1e-12)
    back = np.asarray(plan.rec_split(y_split))
    np.testing.assert_allclose(back[0] + 1j * back[1], x, atol=1e-12)


def test_symlet_engine_roundtrip(rng):
    """symN plans ride every engine path unchanged (same even-length QMF
    machinery); tight frame + exact reconstruction, per-axis mixing with
    db allowed."""
    shape = (24, 20)
    x = rng.standard_normal(shape)
    for wv in ("sym4", ("db2", "sym4")):
        plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=True,
                        dtype="double", path="direct")
        y = plan.dec(x, 2)
        assert abs(np.linalg.norm(np.asarray(y)) / np.linalg.norm(x) - 1) < 1e-12
        assert np.max(np.abs(np.asarray(plan.rec(y)) - x)) < 1e-12
    # fft and direct paths agree for symlets too
    pf = nw.NDDWT(wavelet="sym4", shape=shape, dtype="double", path="fft")
    pd = nw.NDDWT(wavelet="sym4", shape=shape, dtype="double", path="direct")
    np.testing.assert_allclose(
        np.asarray(pf.dec(x, 2)), np.asarray(pd.dec(x, 2)), atol=1e-12
    )
