"""Golden-oracle tests: the three oracle types of the reference test suite
(round-trip identity, Parseval/tight-frame, cross-path agreement —
``Test/nddwt1D_test.m:25-27``) plus what the reference lacks: adjointness
and band-layout checks on deliberately odd sizes."""

import numpy as np
import pytest

from non_decimated_wavelets import oracle

CASES = [
    ((54,), "db4", 3),
    ((33,), ("db2",), 2),
    ((26, 26), "db1", 3),
    ((24, 18), ("db1", "db3"), 2),
    ((16, 14, 10), ("db1", "db3", "db2"), 2),
    ((8, 8, 6, 6), "db2", 2),
]


@pytest.mark.parametrize("shape,wv,lvl", CASES)
@pytest.mark.parametrize("pl2", [False, True])
def test_roundtrip_and_energy(shape, wv, lvl, pl2, rng):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = oracle.dec(x, wv, lvl, preserve_l2=pl2)
    assert y.shape == shape + (oracle.num_bands(len(shape), lvl),)
    xr = oracle.rec(y, wv, preserve_l2=pl2)
    assert np.max(np.abs(xr - x)) < 1e-12
    if pl2:
        # Tight frame: ||y|| == ||x|| (Test/nddwt1D_test.m:26).
        assert abs(np.linalg.norm(y) / np.linalg.norm(x) - 1) < 1e-12


def test_real_in_real_out(rng):
    x = rng.standard_normal((20, 22))
    y = oracle.dec(x, "db3", 2)
    assert not np.iscomplexobj(y)
    xr = oracle.rec(y, "db3")
    assert not np.iscomplexobj(xr)
    assert np.max(np.abs(xr - x)) < 1e-12


@pytest.mark.parametrize("shape,wv", [((24, 18), ("db2", "db3")), ((16, 12, 10), "db2")])
def test_adjointness(shape, wv, rng):
    """<dec(x), y> == <x, rec(y)> for the tight-frame normalization (rec is
    the exact adjoint there; Functions/nd_dwt_3D.m:374)."""
    lvl = 2
    d = len(shape)
    B = oracle.num_bands(d, lvl)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = rng.standard_normal(shape + (B,)) + 1j * rng.standard_normal(shape + (B,))
    lhs = np.vdot(oracle.dec(x, wv, lvl, preserve_l2=True), y)
    rhs = np.vdot(x, oracle.rec(y, wv, preserve_l2=True))
    assert abs(lhs - rhs) < 1e-10 * (1 + abs(lhs))


def test_band_layout_haar_level1(rng):
    """Band order LL, HL, LH, HH with axis-0's filter toggling fastest
    (Functions/nd_dwt_2D.m:305-308), H = difference stencil."""
    x = rng.standard_normal((8, 10))
    y = oracle.dec(x, "db1", 1)
    s = 1 / np.sqrt(2)
    lo0 = s * (x + np.roll(x, -1, 0))
    hi0 = s * (x - np.roll(x, -1, 0))
    expect = [
        s * (lo0 + np.roll(lo0, -1, 1)),  # LL
        s * (hi0 + np.roll(hi0, -1, 1)),  # HL (H on axis 0)
        s * (lo0 - np.roll(lo0, -1, 1)),  # LH
        s * (hi0 - np.roll(hi0, -1, 1)),  # HH
    ]
    for b, e in enumerate(expect):
        np.testing.assert_allclose(y[..., b], e, atol=1e-12)


def test_multilevel_prepend_layout(rng):
    """Deepest level first; level-1 details last (cat-prepend at
    Functions/nd_dwt_3D.m:184): dropping the deepest group of a 2-level
    transform must equal the level-1 details of the level-1 transform."""
    x = rng.standard_normal((16, 16))
    y1 = oracle.dec(x, "db2", 1)
    y2 = oracle.dec(x, "db2", 2)
    np.testing.assert_allclose(y2[..., 4:], y1[..., 1:], atol=1e-12)
    # and the deepest approx band is dec of the level-1 approx band
    y1_again = oracle.dec(y1[..., 0], "db2", 1)
    np.testing.assert_allclose(y2[..., 0], y1_again[..., 0], atol=1e-12)
    np.testing.assert_allclose(y2[..., 1:4], y1_again[..., 1:], atol=1e-12)


def test_level_from_bands():
    assert oracle.level_from_bands(1, 4) == 3
    assert oracle.level_from_bands(2, 10) == 3
    assert oracle.level_from_bands(3, 22) == 3
    assert oracle.level_from_bands(4, 46) == 3
    with pytest.raises(ValueError):
        oracle.level_from_bands(2, 9)


def test_bad_level():
    with pytest.raises(ValueError):
        oracle.dec(np.zeros(8), "db1", 0)
    with pytest.raises(ValueError):
        oracle.dec(np.zeros((8, 8)), ("db1",), 1)  # wrong wavelet count


def test_fuzz_random_configs_vs_oracle():
    import non_decimated_wavelets as nw

    """Seeded fuzz: random (ndim, odd/even extents, db/sym wavelet mix,
    level) configs, direct path vs the NumPy oracle at f64 — broadens the
    hand-picked edge cases (reference sizes, primes, tiny axes)."""
    rng = np.random.default_rng(20260817)
    families = ["db1", "db2", "db3", "db4", "sym4", "db5", "sym3"]
    for _ in range(12):
        ndim = int(rng.integers(1, 5))
        shape, wavelets = [], []
        for _ in range(ndim):
            w = families[int(rng.integers(len(families)))]
            K = 2 * int(w[-1]) if w[-1].isdigit() else 2
            n = int(rng.integers(max(K, 4), 20))
            shape.append(n)
            wavelets.append(w)
        level = int(rng.integers(1, 4))
        pl2 = bool(rng.integers(2))
        x = rng.standard_normal(tuple(shape))
        plan = nw.NDDWT(wavelet=tuple(wavelets), shape=tuple(shape),
                        preserve_l2=pl2, dtype="double", path="direct")
        y = np.asarray(plan.dec(x, level))
        gold = oracle.dec(x, tuple(wavelets), level, preserve_l2=pl2)
        np.testing.assert_allclose(y, gold, atol=1e-11)
        xr = np.asarray(plan.rec(y))
        np.testing.assert_allclose(xr, x, atol=1e-11)
