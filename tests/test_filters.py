"""Filter-layer tests.

The reference hard-codes db1..db10 tables (``wave_filters.m:19-156``); we
generate them by spectral factorization, so these tests pin the mathematics:
QMF orthonormality, vanishing moments, closed-form db1/db2 values, and the
correlation-orientation conventions the engine relies on.
"""

import numpy as np
import pytest

from non_decimated_wavelets import filters as F


@pytest.mark.parametrize("p", list(range(1, 13)))
def test_orthonormality_and_moments(p):
    t = F.daubechies_taps(p)
    assert len(t) == 2 * p
    # sum = sqrt(2)
    assert abs(t.sum() - np.sqrt(2)) < 1e-13
    # double-shift orthonormality: sum_n h[n] h[n+2k] = delta_k
    for k in range(p):
        v = np.dot(t[: len(t) - 2 * k], t[2 * k :])
        assert abs(v - (1.0 if k == 0 else 0.0)) < 1e-12, (p, k, v)
    # p vanishing moments of the high-pass
    u = F.qmf_highpass(t)
    for m in range(p):
        v = np.dot(u, np.arange(len(u), dtype=float) ** m)
        assert abs(v) < 1e-9 * max(1, len(u) ** m), (p, m, v)


def test_db1_db2_closed_form():
    t1 = F.daubechies_taps(1)
    np.testing.assert_allclose(t1, [1 / np.sqrt(2)] * 2, atol=1e-15)
    s3 = np.sqrt(3)
    expected = np.array([1 + s3, 3 + s3, 3 - s3, 1 - s3]) / (4 * np.sqrt(2))
    np.testing.assert_allclose(F.daubechies_taps(2), expected, atol=1e-14)


def test_extremal_phase_orientation():
    # Reference table order has the two large taps first (wave_filters.m:24-28).
    t = F.daubechies_taps(4)
    assert np.argmax(np.abs(t)) < len(t) // 2


def test_qmf_haar_signs():
    # Haar H band must be (x[n] - x[n+1])/sqrt(2): matches the reference
    # Haar stencil (Functions/harr_nddwt_2D.m:250-287).
    lo, hi = F.correlation_taps("db1")
    np.testing.assert_allclose(lo, [1 / np.sqrt(2)] * 2, atol=1e-15)
    np.testing.assert_allclose(hi, [1 / np.sqrt(2), -1 / np.sqrt(2)], atol=1e-15)


def test_decomposition_filters_orientation():
    # wave_filters.m returns both filters time-reversed (lines 162-172):
    # low_d = reverse(table); check against correlation taps.
    lo_c, hi_c = F.correlation_taps("db3")
    low_d, hi_d = F.decomposition_filters("db3")
    np.testing.assert_allclose(low_d, lo_c[::-1], atol=0)
    np.testing.assert_allclose(hi_d, hi_c[::-1], atol=0)


def test_frequency_response_matches_reference_construction():
    # F = shift * fft(low_d, n) with shift = exp(2j pi (K/2) k / n)
    # (Functions/nd_dwt_1D.m:274,288-289).
    n = 37
    low_d, hi_d = F.decomposition_filters("db4")
    K = len(low_d)
    shift = np.exp(2j * np.pi * (K / 2) * np.arange(n) / n)
    ref = np.stack(
        [shift * np.fft.fft(low_d, n), shift * np.fft.fft(hi_d, n)]
    )
    got = F.frequency_response("db4", n)
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_name_parsing_and_errors():
    assert F.parse_wavelet_name("haar") == 1
    assert F.parse_wavelet_name("DB7") == 7
    assert F.parse_wavelet_name("sym4") == 4  # superset family
    with pytest.raises(ValueError):
        F.parse_wavelet_name("coif2")
    with pytest.raises(ValueError):
        F.parse_wavelet_name("db0")
    with pytest.raises(TypeError):
        F.parse_wavelet_name(4)
    with pytest.raises(ValueError):
        F.qmf_highpass(np.ones(5))  # odd length unsupported
    with pytest.raises(ValueError):
        # filter longer than axis: same trigger as the reference error
        # (Functions/nd_dwt_3D.m:277-286)
        F.frequency_response("db4", 5)
    # Order caps must raise FAST: the symlet least-asymmetry search is
    # exponential in p (an unbounded 'sym99' construction hangs — r3
    # verify probe), and db root accuracy degrades past db38.
    with pytest.raises(ValueError, match="exceeds the supported maximum"):
        F.parse_wavelet_name("sym99")
    with pytest.raises(ValueError, match="exceeds the supported maximum"):
        F.parse_wavelet_name("db39")
    with pytest.raises(ValueError, match="exceeds the supported maximum"):
        F.symlet_taps(21)
    with pytest.raises(ValueError, match="exceeds the supported maximum"):
        F.daubechies_taps(39)
    assert F.parse_wavelet_name("db38") == 38
    assert F.parse_wavelet_name("sym20") == 20


# ---------------------------------------------------------------------------
# Reference-table parity: parse the reference's hard-coded db tables at test
# time and pin our spectral-factorization taps to them (this fixes the
# extremal-phase root-selection convention — symlets etc. would pass every
# invariant above but fail here).
# ---------------------------------------------------------------------------

_REF_TABLE = "/root/reference/Functions/wave_filters.m"


def _parse_reference_tables(path):
    """{p: low_d taps} parsed from the reference's switch statement
    (``wave_filters.m:19-156``): ``case {'dbN'}`` then ``low_d = [...];``."""
    import re

    text = open(path).read()
    tables = {}
    for m in re.finditer(r"case\s*\{'db(\d+)'\}(.*?)(?=case\s*\{|otherwise)",
                         text, re.S):
        p = int(m.group(1))
        body = m.group(2)
        vals = re.search(r"low_d\s*=\s*\[(.*?)\]", body, re.S)
        nums = re.findall(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?(?:/sqrt\(2\))?",
                          vals.group(1).replace("...", " "), re.I)
        taps = []
        for s in nums:
            if s.endswith("/sqrt(2)"):
                taps.append(float(s[: -len("/sqrt(2)")]) / np.sqrt(2))
            else:
                taps.append(float(s))
        tables[p] = np.asarray(taps)
    return tables


@pytest.mark.skipif(
    not __import__("os").path.exists(_REF_TABLE),
    reason="reference tables not available",
)
def test_taps_match_reference_tables():
    tables = _parse_reference_tables(_REF_TABLE)
    assert set(tables) == set(range(1, 11))
    for p, ref in tables.items():
        assert len(ref) == 2 * p
        got = F.daubechies_taps(p)
        np.testing.assert_allclose(got, ref, atol=2e-15, rtol=0)


# ---------------------------------------------------------------------------
# Symlets (least-asymmetric Daubechies) — capability superset beyond the
# reference's db table.
# ---------------------------------------------------------------------------
from non_decimated_wavelets.filters import (
    _phase_nonlinearity,
    _scaling_taps_long,
    symlet_taps,
)


@pytest.mark.parametrize("p", [2, 3, 4, 6, 8, 10])
def test_symlet_invariants(p):
    h = symlet_taps(p)
    assert len(h) == 2 * p
    assert abs(h.sum() - np.sqrt(2)) < 1e-14
    # Orthonormality: <h, shift_2k h> = delta_k
    assert abs(np.dot(h, h) - 1.0) < 1e-13
    for s in range(2, 2 * p, 2):
        assert abs(np.dot(h[:-s], h[s:])) < 1e-13
    # p vanishing moments of the quadrature-mirror highpass
    u = F.qmf_highpass(h.astype(np.longdouble)).astype(np.float64)
    j = np.arange(2 * p, dtype=np.float64)
    for m in range(p):
        assert abs(np.dot(j**m, u)) < 1e-9 * (2 * p) ** m


@pytest.mark.parametrize("p", [4, 6, 8])
def test_symlet_is_less_asymmetric_than_db(p):
    asym_sym = _phase_nonlinearity(np.asarray(_scaling_taps_long(f"sym{p}"), float))
    asym_db = _phase_nonlinearity(np.asarray(_scaling_taps_long(f"db{p}"), float))
    assert asym_sym < 0.5 * asym_db


def test_sym4_matches_canonical_taps():
    """Cross-check against the canonical sym4 filter (PyWavelets'
    Wavelet('sym4').dec_lo — the de-facto published values), which equals
    this construction's output reflected (orientation conventions differ
    between libraries by reflection; the frame is identical)."""
    canonical_dec_lo = np.array([
        -0.07576571478927333, -0.02963552764599851, 0.49761866763201545,
        0.8037387518059161, 0.29785779560527736, -0.09921954357684722,
        -0.012603967262037833, 0.0322231006040427,
    ])
    ours = symlet_taps(4)
    np.testing.assert_allclose(ours, canonical_dec_lo[::-1], atol=1e-10)


def test_sym2_equals_db2_up_to_reflection():
    s2 = symlet_taps(2)
    d2 = F.daubechies_taps(2)
    assert (np.allclose(s2, d2, atol=1e-14)
            or np.allclose(s2, d2[::-1], atol=1e-14))
