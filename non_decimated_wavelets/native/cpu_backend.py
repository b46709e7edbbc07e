"""ctypes bridge to the C++ CPU backend (``native/nddwt_cpu.cpp``).

This framework's counterpart of the reference's MEX layer
(``mex/nd_dwt_mex.c``, ``mex/nddwt.c``): a dimension-generic C++/OpenMP
engine computing the direct-path NDDWT on the host, exposed through a small
C ABI loaded with ``ctypes`` (no pybind11 in this environment).

Until the shared library is built (``make -C native``), :func:`available`
returns False and the class API falls back to the JAX backend with a
warning, mirroring how the reference degrades when the MEX binary is absent.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_CANDIDATES = [
    os.path.join(_HERE, "libnddwt_cpu.so"),
    os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "libnddwt_cpu.so"),
]


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    for path in _CANDIDATES:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.nddwt_dec.restype = ctypes.c_int
            lib.nddwt_dec.argtypes = [
                ctypes.c_void_p,  # x (f64, C-order, spatial)
                ctypes.c_void_p,  # y out (f64, band-first, C-order)
                ctypes.POINTER(ctypes.c_long),  # shape
                ctypes.c_int,  # ndim
                ctypes.c_void_p,  # taps, concatenated (2*K per axis)
                ctypes.POINTER(ctypes.c_int),  # per-axis K
                ctypes.c_int,  # level
                ctypes.c_int,  # is_complex (interleaved re/im)
            ]
            lib.nddwt_rec.restype = ctypes.c_int
            lib.nddwt_rec.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_int,
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
                ctypes.c_int,  # preserve_l2
                ctypes.c_int,  # is_complex
            ]
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _load() is not None


def set_num_threads(n: int) -> int:
    """Set the OpenMP thread count (returns the resulting max count).

    The reference hard-codes 8 FFTW threads (``mex/nddwt.c:103``); this is
    adjustable so benchmarks can pin the honest single-core figure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native CPU backend not built (make -C native)")
    lib.nddwt_set_num_threads.restype = ctypes.c_int
    lib.nddwt_set_num_threads.argtypes = [ctypes.c_int]
    return int(lib.nddwt_set_num_threads(int(n)))


def _pack_taps(wavelets, ndim, preserve_l2):
    from ..filters import correlation_taps
    from ..oracle import _normalize_wavelets

    names = _normalize_wavelets(wavelets, ndim)
    scale = 1.0 / np.sqrt(2.0) if preserve_l2 else 1.0
    taps_list, ks = [], []
    for w in names:
        lo, hi = correlation_taps(w)
        ks.append(len(lo))
        taps_list.append(scale * np.stack([lo, hi]).ravel())
    return np.concatenate(taps_list), np.array(ks, dtype=np.int32)


def dec(x: np.ndarray, wavelets, level: int, preserve_l2: bool, precision="double"):
    lib = _load()
    if lib is None:
        raise RuntimeError("native CPU backend not built (make -C native)")
    from ..oracle import num_bands

    is_complex = np.iscomplexobj(x)
    xd = np.ascontiguousarray(x, dtype=np.complex128 if is_complex else np.float64)
    ndim = xd.ndim
    B = num_bands(ndim, level)
    y = np.empty((B,) + xd.shape, dtype=xd.dtype)
    taps, ks = _pack_taps(wavelets, ndim, preserve_l2)
    shape = (ctypes.c_long * ndim)(*xd.shape)
    karr = (ctypes.c_int * ndim)(*ks)
    rc = lib.nddwt_dec(
        xd.ctypes.data_as(ctypes.c_void_p),
        y.ctypes.data_as(ctypes.c_void_p),
        shape,
        ndim,
        taps.ctypes.data_as(ctypes.c_void_p),
        karr,
        int(level),
        int(is_complex),
    )
    if rc != 0:
        raise RuntimeError(f"native nddwt_dec failed with code {rc}")
    out = np.moveaxis(y, 0, -1)
    if precision in ("single", "float32"):
        out = out.astype(np.complex64 if is_complex else np.float32)
    return out


def rec(y: np.ndarray, wavelets, preserve_l2: bool, precision="double"):
    lib = _load()
    if lib is None:
        raise RuntimeError("native CPU backend not built (make -C native)")
    from ..oracle import level_from_bands

    is_complex = np.iscomplexobj(y)
    ndim = y.ndim - 1
    level = level_from_bands(ndim, y.shape[-1])
    yb = np.ascontiguousarray(
        np.moveaxis(y, -1, 0), dtype=np.complex128 if is_complex else np.float64
    )
    x = np.empty(yb.shape[1:], dtype=yb.dtype)
    taps, ks = _pack_taps(wavelets, ndim, preserve_l2)
    shape = (ctypes.c_long * ndim)(*x.shape)
    karr = (ctypes.c_int * ndim)(*ks)
    rc = lib.nddwt_rec(
        yb.ctypes.data_as(ctypes.c_void_p),
        x.ctypes.data_as(ctypes.c_void_p),
        shape,
        ndim,
        taps.ctypes.data_as(ctypes.c_void_p),
        karr,
        int(level),
        int(preserve_l2),
        int(is_complex),
    )
    if rc != 0:
        raise RuntimeError(f"native nddwt_rec failed with code {rc}")
    if precision in ("single", "float32"):
        x = x.astype(np.complex64 if is_complex else np.float32)
    return x
