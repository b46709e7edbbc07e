"""Application-layer tests: shrinkage denoising and CS recon converge —
the iterative loops the reference's filter-cache design existed to serve."""

import jax
import jax.numpy as jnp
import numpy as np

import non_decimated_wavelets as nw
from non_decimated_wavelets.models import (
    denoise,
    fista_cs_mri,
    fista_inpaint,
    fista_inpaint_split,
    soft_threshold,
)


def test_soft_threshold_complex():
    y = jnp.asarray([3 + 4j, 0.1 + 0.1j, -2.0])
    out = np.asarray(soft_threshold(y, 1.0))
    np.testing.assert_allclose(out[0], (3 + 4j) * (4 / 5), atol=1e-12)
    assert abs(out[1]) < 1e-12  # below threshold -> zero
    np.testing.assert_allclose(out[2], -1.0, atol=1e-12)


def test_denoise_reduces_noise(rng):
    n = 64
    t = np.linspace(0, 1, n, endpoint=False)
    clean = np.sign(np.sin(2 * np.pi * 3 * t)).astype(np.float64)  # piecewise const
    noisy = clean + 0.3 * rng.standard_normal(n)
    plan = nw.NDDWT(wavelet="db2", shape=(n,), preserve_l2=True, dtype="double")
    out = np.asarray(denoise(plan, jnp.asarray(noisy), 3, lam=0.15))
    assert np.linalg.norm(out - clean) < 0.85 * np.linalg.norm(noisy - clean)


def test_denoise_zero_lambda_is_identity(rng):
    x = rng.standard_normal((24, 24))
    plan = nw.NDDWT(wavelet="db3", shape=(24, 24), dtype="double")
    out = np.asarray(denoise(plan, jnp.asarray(x), 2, lam=0.0))
    np.testing.assert_allclose(out, x, atol=1e-10)


def test_fista_cs_recovers(rng):
    """Undersampled-Fourier recovery of a wavelet-sparse image."""
    n = 32
    img = np.zeros((n, n))
    img[8:24, 10:20] = 1.0
    img[12:16, 12:16] = 2.0
    mask = (rng.random((n, n)) < 0.5).astype(np.float64)
    mask[0, 0] = 1.0  # keep DC
    b = mask * np.fft.fftn(img, norm="ortho")
    plan = nw.NDDWT(wavelet="db1", shape=(n, n), preserve_l2=True, dtype="double")
    x = np.asarray(
        fista_cs_mri(plan, jnp.asarray(b), jnp.asarray(mask), lam=5e-3, level=2, iters=60)
    )
    x = np.real(x)
    zf = np.real(np.fft.ifftn(b, norm="ortho"))  # zero-filled recon
    assert np.linalg.norm(x - img) < 0.2 * np.linalg.norm(zf - img)


def test_fista_inpaint_split_matches_complex(rng):
    """The split-complex FISTA is numerically identical to the
    complex-arithmetic loop: real filters + joint-magnitude shrink
    == complex soft-threshold (the reference's complex contract,
    Functions/nd_dwt_3D.m:150-154)."""
    n = 32
    xc = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    mask = (rng.random((n, n)) < 0.6).astype(np.float64)
    b = mask * xc
    plan = nw.NDDWT(wavelet="db2", shape=(n, n), preserve_l2=True,
                    dtype="double")
    ref = np.asarray(
        fista_inpaint(plan, jnp.asarray(b), jnp.asarray(mask), lam=0.02,
                      level=2, iters=15)
    )
    pair = jnp.asarray(np.stack([b.real, b.imag]))
    out = np.asarray(
        fista_inpaint_split(plan, pair, jnp.asarray(mask), lam=0.02,
                            level=2, iters=15)
    )
    np.testing.assert_allclose(out[0] + 1j * out[1], ref, atol=1e-12)


def test_fista_inpaint_split_sharded_matches_single(rng):
    """Complex FISTA on the multi-device path: ShardedNDDWT split transform
    inside the same loop reproduces the single-device result."""
    from non_decimated_wavelets.parallel.sharded import ShardedNDDWT
    from tests.test_sharded import _skip_if_few_devices, make_mesh

    _skip_if_few_devices(4)
    n = 32
    xc = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    mask = (rng.random((n, n)) < 0.6).astype(np.float64)
    b = mask * xc
    plan = nw.NDDWT(wavelet="db2", shape=(n, n), preserve_l2=True,
                    dtype="double")
    ref = np.asarray(
        fista_inpaint(plan, jnp.asarray(b), jnp.asarray(mask), lam=0.02,
                      level=2, iters=10)
    )
    mesh = make_mesh({"x": 4})
    sh = ShardedNDDWT(plan, mesh, ("x", None))
    pair = sh.shard_input_split(jnp.asarray(np.stack([b.real, b.imag])))
    out = np.asarray(
        fista_inpaint_split(sh, pair, jnp.asarray(mask), lam=0.02,
                            level=2, iters=10)
    )
    np.testing.assert_allclose(out[0] + 1j * out[1], ref, atol=1e-12)


def test_fista_inpaint_split_traced_lam(rng):
    """Traced (jnp scalar) lam with a single-device plan must run the
    generic composition, not raise (review r3 finding 1)."""
    n = 16
    xc = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    mask = (rng.random((n, n)) < 0.6).astype(np.float64)
    plan = nw.NDDWT(wavelet="db2", shape=(n, n), preserve_l2=True,
                    dtype="double")
    pair = jnp.asarray(np.stack([(mask * xc).real, (mask * xc).imag]))
    ref = fista_inpaint_split(plan, pair, jnp.asarray(mask), 0.05,
                              level=1, iters=4)
    out = fista_inpaint_split(plan, pair, jnp.asarray(mask),
                              jnp.float64(0.05), level=1, iters=4)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-12)


def test_fista_inpaint_complex_cpu(rng):
    """Complex b runs the complex-capable loop; nothing casts it to real."""
    n = 16
    xc = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    mask = (rng.random((n, n)) < 0.6).astype(np.float64)
    b = jnp.asarray(mask * xc)
    plan = nw.NDDWT(wavelet="db2", shape=(n, n), preserve_l2=True,
                    dtype="double", path="direct")
    out = fista_inpaint(plan, b, jnp.asarray(mask), 0.05, level=1, iters=4)
    assert np.iscomplexobj(np.asarray(out))
    ref = fista_inpaint(plan, b, jnp.asarray(mask), jnp.float64(0.05),
                        level=1, iters=4)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-12)
