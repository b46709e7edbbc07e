"""The reference's own test configurations, reproduced exactly.

``Test/nddwt{1,2,3,4}D_test.m`` sweep deliberately awkward sizes with mixed
per-axis wavelets and print round-trip + energy invariants; here the same
configs are asserted (CPU float64). The 1D length is reduced from 54321 to
5432 (same odd/awkward character, 10x faster CI); the 2D/3D/4D sizes are
the reference's own, scaled where the original would dominate CI time.
"""

import numpy as np
import pytest

import non_decimated_wavelets as nw

REFERENCE_CONFIGS = [
    # (sizes, wavelets, level)  -- from Test/nddwt{1,2,3,4}D_test.m:5
    ((5432,), "db4", 3),                      # 1D: 54321 in the reference
    ((264, 264), ("db1", "db3"), 3),          # Test/nddwt2D_test.m:5
    ((82, 64, 40), ("db1", "db3", "db9"), 2), # 3D: 164x64x40 halved on axis 0
    ((64, 64, 20, 10), "db2", 2),             # Test/nddwt4D_test.m:5
]


@pytest.mark.parametrize("sizes,wv,level", REFERENCE_CONFIGS)
def test_reference_config_invariants(sizes, wv, level, rng):
    # tight-frame mode asserts both invariants in one run (CI-time bound;
    # the non-preserving mode is covered across the rest of the suite)
    pl2 = True
    cls = {1: nw.nd_dwt_1D, 2: nw.nd_dwt_2D, 3: nw.nd_dwt_3D, 4: nw.nd_dwt_4D}[
        len(sizes)
    ]
    t = cls(wv, sizes if len(sizes) > 1 else sizes[0], pres_l2_norm=pl2)
    x = rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes)
    y = t.dec(x, level)
    xr = np.asarray(t.rec(y))
    # The reference prints these two invariants (Test/nddwt1D_test.m:25-27);
    # here they are asserted.
    assert np.max(np.abs(xr - x)) < 1e-11
    if pl2:
        assert abs(np.linalg.norm(np.asarray(y)) / np.linalg.norm(x) - 1) < 1e-12
