"""Native C++ backend tests — the cross-backend tier of the reference suite
(mat vs mex agreement, ``mex/mex_test.m``) recast as oracle-vs-native
asserts. Builds the shared library on demand if a compiler is present."""

import subprocess

import numpy as np
import pytest

from non_decimated_wavelets import oracle
from non_decimated_wavelets.native import cpu_backend


@pytest.fixture(scope="module", autouse=True)
def built():
    if not cpu_backend.available():
        try:
            subprocess.run(["make", "-C", "native"], check=True, capture_output=True)
        except Exception:
            pytest.skip("native backend not built and no toolchain")
        cpu_backend._LIB_TRIED = False  # re-probe
        if not cpu_backend.available():
            pytest.skip("native backend unavailable")


CASES = [
    ((54,), "db4", 3),
    ((26, 22), ("db2", "db3"), 3),
    ((16, 14, 10), ("db1", "db4", "db2"), 2),
    ((8, 12, 10, 6), "db2", 2),
]


@pytest.mark.parametrize("shape,wv,lvl", CASES)
@pytest.mark.parametrize("pl2", [False, True])
def test_native_matches_oracle_real(shape, wv, lvl, pl2, rng):
    x = rng.standard_normal(shape)
    y = cpu_backend.dec(x, wv, lvl, pl2)
    np.testing.assert_allclose(y, oracle.dec(x, wv, lvl, preserve_l2=pl2), atol=1e-12)
    xr = cpu_backend.rec(y, wv, pl2)
    np.testing.assert_allclose(xr, x, atol=1e-12)


def test_native_complex(rng):
    shape, wv, lvl = (20, 18), ("db3", "db2"), 2
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = cpu_backend.dec(x, wv, lvl, False)
    np.testing.assert_allclose(y, oracle.dec(x, wv, lvl), atol=1e-12)
    xr = cpu_backend.rec(y, wv, False)
    np.testing.assert_allclose(xr, x, atol=1e-12)


def test_native_via_class_api(rng):
    import non_decimated_wavelets as nw

    t = nw.nd_dwt_2D("db2", (24, 24), compute="mex")  # reference alias
    assert t.compute == "native"
    x = rng.standard_normal((24, 24))
    y = t.dec(x, 2)
    np.testing.assert_allclose(y, oracle.dec(x, "db2", 2), atol=1e-12)
    np.testing.assert_allclose(t.rec(y), x, atol=1e-12)


def test_native_symlets_match_oracle(rng):
    """The C++ backend is filter-agnostic (taps computed host-side): the
    symlet superset rides it unchanged."""
    from non_decimated_wavelets.native import cpu_backend as cb

    if not cb.available():
        pytest.skip("native backend not built")
    x = rng.standard_normal((20, 16))
    y = cb.dec(x, "sym4", 2, False)
    np.testing.assert_allclose(y, oracle.dec(x, "sym4", 2), atol=1e-12)
    np.testing.assert_allclose(cb.rec(y, "sym4", False), x, atol=1e-12)
