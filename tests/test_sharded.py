"""Sharded-transform tests on a virtual 8-device CPU mesh — the multi-device
tier the reference never had (its only parallelism was 8 FFTW threads,
``mex/nddwt.c:103``). Oracle agreement proves the halo exchange reproduces
the periodic boundary exactly, including the first<->last shard wrap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import non_decimated_wavelets as nw
from non_decimated_wavelets import oracle
from non_decimated_wavelets.parallel import ShardedNDDWT, make_mesh


def _skip_if_few_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


@pytest.mark.parametrize(
    "shape,wv,spec,mesh_shape",
    [
        ((64,), "db4", ("x",), {"x": 8}),
        ((32, 24), ("db2", "db3"), ("x", "y"), {"x": 4, "y": 2}),
        ((32, 24), "db2", ("x", None), {"x": 8}),
        ((16, 16, 12), "db2", ("x", "y", None), {"x": 2, "y": 2}),
        ((16, 8, 6, 6), "db1", ("x", None, None, None), {"x": 4}),
    ],
)
@pytest.mark.parametrize("pl2", [False, True])
def test_sharded_matches_oracle(shape, wv, spec, mesh_shape, pl2, rng):
    _skip_if_few_devices(int(np.prod(list(mesh_shape.values()))))
    mesh = make_mesh(mesh_shape)
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype="double")
    sh = ShardedNDDWT(plan, mesh, spec)
    x = rng.standard_normal(shape)
    xs = sh.shard_input(jnp.asarray(x))
    level = 2
    y = sh.dec(xs, level)
    gold = np.moveaxis(oracle.dec(x, wv, level, preserve_l2=pl2), -1, 0)
    np.testing.assert_allclose(np.asarray(y), gold, atol=1e-12)
    xr = sh.rec(y)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-12)


def test_output_shardings():
    _skip_if_few_devices(8)
    mesh = make_mesh({"x": 8})
    plan = nw.NDDWT(wavelet="db2", shape=(64, 16), dtype="double")
    sh = ShardedNDDWT(plan, mesh, ("x", None))
    x = sh.shard_input(jnp.zeros((64, 16)))
    y = sh.dec(x, 2)
    # Band axis replicated, spatial axis 0 sharded over 'x'.
    def norm(spec, ndim):
        t = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
        return t

    assert norm(y.sharding.spec, 3) == (None, "x", None)
    xr = sh.rec(y)
    assert norm(xr.sharding.spec, 2) == ("x", None)


def test_complex_sharded(rng):
    _skip_if_few_devices(4)
    mesh = make_mesh({"x": 4})
    plan = nw.NDDWT(wavelet="db3", shape=(48,), dtype="double")
    sh = ShardedNDDWT(plan, mesh, ("x",))
    x = rng.standard_normal(48) + 1j * rng.standard_normal(48)
    y = sh.dec(sh.shard_input(jnp.asarray(x)), 3)
    gold = np.moveaxis(oracle.dec(x, "db3", 3), -1, 0)
    np.testing.assert_allclose(np.asarray(y), gold, atol=1e-12)


def test_validation_errors():
    _skip_if_few_devices(8)
    mesh = make_mesh({"x": 8})
    plan = nw.NDDWT(wavelet="db2", shape=(30, 16), dtype="double")
    with pytest.raises(ValueError):
        ShardedNDDWT(plan, mesh, ("x", None))  # 30 not divisible by 8
    with pytest.raises(ValueError):
        ShardedNDDWT(plan, mesh, ("bogus", None))
    plan2 = nw.NDDWT(wavelet="db10", shape=(32, 32), dtype="double")
    with pytest.raises(ValueError):
        # local shard (4) < per-neighbor halo (K//2 = 10)
        ShardedNDDWT(plan2, mesh, ("x", None))
    with pytest.raises(ValueError):
        ShardedNDDWT(plan, mesh, ("x",))  # wrong spec arity


# --------------------------------------------------------------------------
# Pencil FFT-path sharding (all_to_all resharding; SURVEY §5 regime (b)).
# --------------------------------------------------------------------------
from non_decimated_wavelets.parallel import ShardedFFTNDDWT


@pytest.mark.parametrize(
    "shape,wv,lvl,pl2",
    [
        ((32, 24), ("db2", "db3"), 2, False),
        ((16, 16, 12), "db2", 2, True),
        ((24, 8, 6, 6), "db1", 2, False),
    ],
)
def test_pencil_fft_matches_oracle(shape, wv, lvl, pl2, rng):
    _skip_if_few_devices(4)
    mesh = make_mesh({"x": 4})
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype="double")
    sh = ShardedFFTNDDWT(plan, mesh, "x")
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = sh.dec(sh.shard_input(jnp.asarray(x)), lvl)
    gold = np.moveaxis(oracle.dec(x, wv, lvl, preserve_l2=pl2), -1, 0)
    np.testing.assert_allclose(np.asarray(y), gold, atol=1e-12)
    xr = sh.rec(y)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-12)


def test_pencil_fft_validation():
    _skip_if_few_devices(8)
    mesh = make_mesh({"x": 8})
    plan = nw.NDDWT(wavelet="db2", shape=(30, 16), dtype="double")
    with pytest.raises(ValueError):
        ShardedFFTNDDWT(plan, mesh, "x")  # 30 % 8 != 0
    plan1 = nw.NDDWT(wavelet="db2", shape=(64,), dtype="double")
    with pytest.raises(ValueError):
        ShardedFFTNDDWT(plan1, mesh, "x")  # ndim < 2


def test_batch_spec_composes_with_spatial(rng):
    """Leading batch (DP) axes compose with spatial sharding in one
    shard_map — the mesh shape the multi-chip dryrun exercises."""
    _skip_if_few_devices(8)
    mesh = make_mesh({"data": 2, "x": 4})
    plan = nw.NDDWT(wavelet="db2", shape=(32, 16), dtype="double")
    sh = ShardedNDDWT(plan, mesh, ("x", None), batch_spec=("data",))
    xb = rng.standard_normal((4, 32, 16))
    xs = jax.device_put(jnp.asarray(xb), sh.x_sharding)
    y = sh.dec(xs, 2)
    assert y.shape == (7, 4, 32, 16)
    for i in range(4):
        gold = np.moveaxis(oracle.dec(xb[i], "db2", 2), -1, 0)
        np.testing.assert_allclose(np.asarray(y[:, i]), gold, atol=1e-12)
    xr = sh.rec(y)
    np.testing.assert_allclose(np.asarray(xr), xb, atol=1e-12)


# --------------------------------------------------------------------------
# float32 on the XLA shard bodies: the multi-device compute path must match
# the oracle, including the first<->last shard wrap riding ppermute, on
# every mesh layout (one or two sharded axes, several shards per axis,
# size-1 mesh axes, long filters).
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,wv,spec,mesh_shape,level",
    [
        ((64, 256), "db4", ("x", None), {"x": 4}, 2),
        ((32, 32, 128), ("db2", "db3", "db4"), ("x", "y", None), {"x": 2, "y": 2}, 2),
        ((16, 16, 128), "db1", ("x", None, None), {"x": 2}, 3),
        ((16, 32, 128), "db4", (None, "y", None), {"y": 2}, 2),
        ((64, 32, 128), "db4", ("x", None, None), {"x": 2}, 2),
        ((64, 64, 128), "db2", ("x", "y", None), {"x": 2, "y": 2}, 2),
        # db10 halo (9/10 rows) against a 24-row local shard
        ((96, 32, 128), "db10", ("x", None, None), {"x": 4}, 1),
        # size-1 mesh axes: the periodic neighbor is the shard itself
        ((32, 32, 128), "db4", ("x", None, None), {"x": 1}, 3),
        ((32, 32, 128), "db2", ("x", "y", None), {"x": 1, "y": 1}, 2),
        ((32, 32, 128), "db2", ("x", "y", None), {"x": 2, "y": 1}, 2),
    ],
)
@pytest.mark.parametrize("pl2", [False, True])
def test_sharded_f32_matches_oracle(shape, wv, spec, mesh_shape, level, pl2, rng):
    _skip_if_few_devices(int(np.prod(list(mesh_shape.values()))))
    mesh = make_mesh(mesh_shape)
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype=jnp.float32)
    sh = ShardedNDDWT(plan, mesh, spec)
    x = rng.standard_normal(shape).astype(np.float32)
    xs = sh.shard_input(jnp.asarray(x))
    y = sh.dec(xs, level)
    xr = sh.rec(y)
    gold = np.moveaxis(
        oracle.dec(np.asarray(x, np.float64), wv, level, preserve_l2=pl2), -1, 0
    )
    np.testing.assert_allclose(np.asarray(y), gold, atol=1e-4)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-4)


@pytest.mark.parametrize(
    "shape,wv,spec,mesh_shape,level",
    [
        ((16, 16, 8, 16), "db2", ("x", "y", None, None), {"x": 2, "y": 2}, 2),
        ((32, 16, 4, 32), "db1", ("x", None, None, None), {"x": 4}, 2),
        ((64, 16, 4, 32), "db2", ("x", None, None, None), {"x": 2}, 2),
        ((32, 16, 4, 32), "db2", ("x", None, None, None), {"x": 1}, 2),
    ],
)
def test_sharded_4d_f32_matches_oracle(shape, wv, spec, mesh_shape, level, rng):
    """4D sharded over the leading axes, float32."""
    _skip_if_few_devices(int(np.prod(list(mesh_shape.values()))))
    mesh = make_mesh(mesh_shape)
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32)
    sh = ShardedNDDWT(plan, mesh, spec)
    x = rng.standard_normal(shape).astype(np.float32)
    xs = sh.shard_input(jnp.asarray(x))
    y = sh.dec(xs, level)
    xr = sh.rec(y)
    gold = np.moveaxis(
        oracle.dec(np.asarray(x, np.float64), wv, level), -1, 0
    )
    np.testing.assert_allclose(np.asarray(y), gold, atol=1e-4)
    np.testing.assert_allclose(np.asarray(xr), x, atol=1e-4)


def test_halo_validation_allows_half_filter_shards(rng):
    """The XLA halo-exchange body needs only K//2 rows per neighbor; a
    db4 (K=8) plan over 8 shards of a 32-row axis (local 4 = K//2) must
    construct and round-trip (previously rejected with a K-1 bound)."""
    _skip_if_few_devices(8)
    mesh = make_mesh({"x": 8})
    plan = nw.NDDWT(wavelet="db4", shape=(32, 16), dtype="double")
    sh = ShardedNDDWT(plan, mesh, ("x", None))
    x = rng.standard_normal((32, 16))
    xs = sh.shard_input(jnp.asarray(x))
    y = sh.dec(xs, 2)
    xr = np.asarray(sh.rec(y))
    np.testing.assert_allclose(xr, x, atol=1e-12)

# --------------------------------------------------------------------------
# Sharded split-complex: complex volumes as a (2, *spatial) re/im pair, the
# pair axis leading and unsharded (the reference handles complex natively,
# Functions/nd_dwt_3D.m:150-154).
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,wv,spec,mesh_shape,level,f32",
    [
        ((32, 16), "db2", ("x", None), {"x": 4}, 2, False),
        ((64, 256), "db4", ("x", None), {"x": 4}, 2, True),
        ((32, 32, 128), ("db2", "db3", "db4"), ("x", "y", None),
         {"x": 2, "y": 2}, 2, True),
    ],
)
def test_sharded_split_complex_matches_oracle(shape, wv, spec, mesh_shape,
                                              level, f32, rng):
    _skip_if_few_devices(int(np.prod(list(mesh_shape.values()))))
    mesh = make_mesh(mesh_shape)
    dt = jnp.float32 if f32 else "double"
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=dt)
    sh = ShardedNDDWT(plan, mesh, spec)
    xc = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    pair = np.stack([xc.real, xc.imag]).astype(np.asarray(jnp.zeros(0, dt)).dtype)
    ps = sh.shard_input_split(jnp.asarray(pair))
    y = sh.dec_split(ps, level)
    xr = sh.rec_split(y)
    gold = np.moveaxis(oracle.dec(xc, wv, level), -1, 0)
    tol = 1e-4 if f32 else 1e-12
    assert y.shape == (2, plan.num_bands(level)) + shape
    np.testing.assert_allclose(np.asarray(y[0]), gold.real, atol=tol)
    np.testing.assert_allclose(np.asarray(y[1]), gold.imag, atol=tol)
    np.testing.assert_allclose(np.asarray(xr[0]), xc.real, atol=tol)
    np.testing.assert_allclose(np.asarray(xr[1]), xc.imag, atol=tol)


def test_sharded_split_rejects_batch_spec():
    _skip_if_few_devices(8)
    mesh = make_mesh({"data": 2, "x": 4})
    plan = nw.NDDWT(wavelet="db2", shape=(32, 16), dtype="double")
    sh = ShardedNDDWT(plan, mesh, ("x", None), batch_spec=("data",))
    with pytest.raises(ValueError, match="batch"):
        sh.dec_split_fn(2)


# --------------------------------------------------------------------------
# Sharded iterate: dec -> shrink -> rec in one shard_map region.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", [0.0, 0.25])
def test_sharded_dec_rec_xla(threshold, rng):
    """XLA body: dec_rec == explicit dec + detail-shrink + rec."""
    _skip_if_few_devices(4)
    mesh = make_mesh({"x": 4})
    plan = nw.NDDWT(wavelet="db2", shape=(32, 24), preserve_l2=True,
                    dtype="double")
    sh = ShardedNDDWT(plan, mesh, ("x", None))
    x = rng.standard_normal((32, 24))
    xs = sh.shard_input(jnp.asarray(x))
    y, xr = sh.dec_rec(xs, 2, threshold=threshold)
    yref = sh.dec(xs, 2)
    if threshold:
        mag = np.abs(np.asarray(yref[1:]))
        fac = np.maximum(mag - threshold, 0.0) / np.maximum(mag, 1e-30)
        yref = jnp.concatenate(
            [yref[:1], yref[1:] * jnp.asarray(fac)], axis=0
        )
    np.testing.assert_allclose(np.asarray(y), np.asarray(yref), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(xr), np.asarray(sh.rec(yref)), atol=1e-12
    )


def test_sharded_dec_rec_f32_shrink_matches_oracle(rng):
    """float32 sharded iterate: the detail shrink matches the oracle
    dec + shrink + rec."""
    _skip_if_few_devices(2)
    mesh = make_mesh({"x": 2})
    shape, level, lam = (64, 32, 128), 2, 0.3
    plan = nw.NDDWT(wavelet="db4", shape=shape, preserve_l2=True,
                    dtype=jnp.float32)
    sh = ShardedNDDWT(plan, mesh, ("x", None, None))
    x = rng.standard_normal(shape).astype(np.float32)
    xs = sh.shard_input(jnp.asarray(x))
    y, xr = sh.dec_rec(xs, level, threshold=lam)
    gold = np.moveaxis(
        oracle.dec(np.asarray(x, np.float64), "db4", level, preserve_l2=True),
        -1, 0,
    )
    mag = np.abs(gold[1:])
    gold = np.concatenate(
        [gold[:1],
         gold[1:] * (np.maximum(mag - lam, 0.0) / np.maximum(mag, 1e-30))],
        axis=0,
    )
    np.testing.assert_allclose(np.asarray(y), gold, atol=1e-4)
    xref = oracle.rec(np.moveaxis(gold, 0, -1), "db4", preserve_l2=True)
    np.testing.assert_allclose(np.asarray(xr), xref, atol=1e-4)


def test_fista_inpaint_sharded_fused(rng):
    """fista_inpaint on a ShardedNDDWT routes through the one-region
    sharded iterate and matches the single-device result."""
    from non_decimated_wavelets.models import fista_inpaint

    _skip_if_few_devices(4)
    n = 32
    x0 = rng.standard_normal((n, n))
    mask = (rng.random((n, n)) < 0.6).astype(np.float64)
    b = jnp.asarray(mask * x0)
    plan = nw.NDDWT(wavelet="db2", shape=(n, n), preserve_l2=True,
                    dtype="double")
    ref = np.asarray(
        fista_inpaint(plan, b, jnp.asarray(mask), 0.05, level=2, iters=10)
    )
    mesh = make_mesh({"x": 4})
    sh = ShardedNDDWT(plan, mesh, ("x", None))
    out = np.asarray(
        fista_inpaint(sh, sh.shard_input(b), jnp.asarray(mask), 0.05,
                      level=2, iters=10)
    )
    np.testing.assert_allclose(out, ref, atol=1e-12)


@pytest.mark.parametrize("f32", [False, True])
def test_sharded_dec_rec_split_matches_complex(f32, rng):
    """Sharded split-complex iterate == complex dec + complex
    soft-threshold + rec (oracle; f32 tolerance for float32)."""
    _skip_if_few_devices(2)
    mesh = make_mesh({"x": 2})
    if f32:
        shape, wv, dt, atol = (32, 16, 128), "db3", jnp.float32, 1e-4
    else:
        shape, wv, dt, atol = (32, 24), "db3", "double", 1e-12
    lam, level = 0.3, 2
    plan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=True, dtype=dt)
    sh = ShardedNDDWT(plan, mesh, ("x",) + (None,) * (len(shape) - 1))
    xc = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    pair = sh.shard_input_split(
        jnp.asarray(np.stack([xc.real, xc.imag]), plan.real_dtype)
    )
    y, xr = sh.dec_rec_split(pair, level, threshold=lam)
    gold = np.moveaxis(
        oracle.dec(xc, wv, level, preserve_l2=True), -1, 0
    )
    mag = np.abs(gold[1:])
    fac = np.maximum(mag - lam, 0.0) / np.maximum(mag, 1e-30)
    gold = np.concatenate([gold[:1], gold[1:] * fac], axis=0)
    got = np.asarray(y[0]) + 1j * np.asarray(y[1])
    np.testing.assert_allclose(got, gold, atol=atol)
    xref = oracle.rec(np.moveaxis(gold, 0, -1), wv, preserve_l2=True)
    np.testing.assert_allclose(
        np.asarray(xr[0]) + 1j * np.asarray(xr[1]), xref, atol=atol
    )


@pytest.mark.parametrize(
    "shape,wv,spec,mesh_shape,level,f32",
    [
        # float64 (exact check vs the plain pair)
        ((16, 16, 12), "db2", ("x", "y", None), {"x": 2, "y": 2}, 2, False),
        ((16, 8, 6, 6), "db1", ("x", None, None, None), {"x": 4}, 2, False),
        # float32, 3D and 4D
        ((32, 32, 128), "db4", ("x", None, None), {"x": 2}, 3, True),
        ((16, 16, 8, 16), "db2", ("x", "y", None, None), {"x": 2, "y": 2},
         2, True),
    ],
)
@pytest.mark.parametrize("threshold", [0.0, 0.1])
def test_streamed_pair_matches_classic(shape, wv, spec, mesh_shape, level,
                                       f32, threshold, rng):
    """The level-streamed fused iterate (BASELINE config #5 memory
    layout: one level's bands live at a time, recompute-on-the-way-up)
    must equal the classic materialize-all-bands iterate exactly."""
    _skip_if_few_devices(int(np.prod(list(mesh_shape.values()))))
    mesh = make_mesh(mesh_shape)
    dt = jnp.float32 if f32 else "double"
    plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=dt)
    sh = ShardedNDDWT(plan, mesh, spec)
    x = rng.standard_normal(shape)
    if f32:
        x = x.astype(np.float32)
    xs = sh.shard_input(jnp.asarray(x))
    xr_s = sh.dec_rec_streamed(xs, level, threshold)
    _, xr_c = sh.dec_rec(xs, level, threshold)
    atol = 1e-5 if f32 else 1e-12
    np.testing.assert_allclose(np.asarray(xr_s), np.asarray(xr_c),
                               atol=atol)
    if not threshold:
        np.testing.assert_allclose(np.asarray(xr_s), np.asarray(x),
                                   atol=atol)


def test_peak_memory_model_config5_math():
    """The config-#5 feasibility numbers documented in DESIGN.md follow
    from the model: for 4D db4 L3 the full-band layout holds 46 bands + 2
    + an 8-volume axis-pass temp, the streamed layout 3 + 1 + 16 + 1 + 8
    local volumes (1.93x less)."""
    mesh = make_mesh({"x": 1})
    plan = nw.NDDWT(wavelet="db4", shape=(64, 64, 64, 32),
                    dtype=jnp.float32)
    sh = ShardedNDDWT(plan, mesh, ("x", None, None, None))
    m = sh.peak_memory_model(3)
    vox = 64 * 64 * 64 * 32
    assert m["local_voxels"] == vox
    assert m["full_band_layout_bytes"] == (46 + 2 + 8) * vox * 4
    assert m["streamed_layout_bytes"] == 29 * vox * 4
    assert 1.9 < m["ratio"] < 2.0
