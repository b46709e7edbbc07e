"""Reference-compatible class API.

Mirrors the six public classes of the reference
(``Functions/nd_dwt_{1,2,3,4}D.m``, ``Functions/harr_nddwt_{2,4}D.m``): each
has ``ctor(wname, sizes, **opts)`` / ``dec(x, level)`` / ``rec(y)`` with the
reference's option names (``pres_l2_norm``, ``compute``, ``precision``) and
the reference band layout ``[n1..nd, B]``.

``compute`` maps reference backends to this framework's:

=============  =====================================================
reference      this framework
=============  =====================================================
``'mat'``      ``'offload'`` — host NumPy in/out (the reference's
               ``'mat'`` contract), XLA compute underneath
``'mex'``      ``'native'`` — C++ CPU backend (falls back to 'jax'
               with a warning until the extension is built)
``'gpu'``      ``'jax'`` — accelerator-resident inputs/outputs
``'gpu_off'``  ``'offload'`` — host NumPy in/out, transfer per call
               (``Functions/nd_dwt_1D.m:139-141,192-194``)
``'numpy'``    pure-NumPy float64 oracle (test anchor)
=============  =====================================================

Unknown options warn rather than error, as in the reference
(``Functions/nd_dwt_1D.m:112``).
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from . import oracle as _oracle
from .plan import NDDWT

_WARNED_X64 = False

_COMPUTE_ALIASES = {
    # 'mat' is host-in/host-out in the reference (plain MATLAB arrays);
    # 'gpu' is device-resident (Functions/nd_dwt_1D.m:129-131 vs 139-141).
    "mat": "offload",
    "gpu": "jax",
    "jax": "jax",
    "gpu_off": "offload",
    "offload": "offload",
    "mex": "native",
    "native": "native",
    "numpy": "numpy",
}


class _NdDwtBase:
    """Shared implementation for the per-dimension classes."""

    _NDIM: int = 0
    _FORCE_PATH: str | None = None

    def __init__(self, wname, sizes, **options):
        if np.isscalar(sizes):
            sizes = (int(sizes),)
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != self._NDIM:
            raise ValueError(
                f"{type(self).__name__} expects {self._NDIM} sizes, got {len(sizes)}"
            )

        pres_l2_norm = False
        compute = "jax"
        precision = "double"
        path = self._FORCE_PATH or "auto"
        for key, val in options.items():
            k = key.lower()
            if k == "pres_l2_norm" or k == "preserve_l2":
                pres_l2_norm = bool(val)
            elif k == "compute":
                if str(val).lower() not in _COMPUTE_ALIASES:
                    raise ValueError(f"Unknown compute mode {val!r}")
                compute = _COMPUTE_ALIASES[str(val).lower()]
            elif k == "precision":
                precision = val
            elif k == "path":
                path = val
            else:
                # Reference warns on unknown options (Functions/nd_dwt_1D.m:112).
                warnings.warn(f"Unknown optional input {key!r}; ignoring", stacklevel=2)

        self.wname = wname
        self.sizes = sizes
        self.pres_l2_norm = pres_l2_norm
        self.compute = compute
        self.precision = "single" if str(precision).lower() in ("single", "float32") else "double"
        if self.precision == "double" and not jax.config.read("jax_enable_x64"):
            if compute in ("jax", "offload"):
                global _WARNED_X64
                if not _WARNED_X64:
                    # warn once per process: 'double' is the reference's
                    # default, so this fires on every default-construction
                    # otherwise
                    warnings.warn(
                        "double precision requested but jax_enable_x64 is off; "
                        "computing in float32. Enable x64 or pass "
                        "precision='single'. (warned once)",
                        stacklevel=2,
                    )
                    _WARNED_X64 = True
                self.precision = "single"

        if compute == "native":
            from .native import cpu_backend

            if not cpu_backend.available():
                warnings.warn(
                    "native CPU backend not built; falling back to compute='jax'",
                    stacklevel=2,
                )
                self.compute = "jax"

        if self.compute != "numpy":
            dtype = jnp.float32 if self.precision == "single" else jnp.float64
            self.plan = NDDWT(
                wavelet=wname,
                shape=sizes,
                preserve_l2=pres_l2_norm,
                dtype=dtype,
                path=path,
            )
        else:
            self.plan = None
        from .filters import correlation_taps

        wavelets = _oracle._normalize_wavelets(wname, len(sizes))
        self.f_size = tuple(len(correlation_taps(w)[0]) for w in wavelets)

    # ------------------------------------------------------------------ dec
    def dec(self, x, level):
        x = self._prepare_input(x)
        if self.compute == "numpy":
            return _oracle.dec(
                np.asarray(x), self.wname, int(level), preserve_l2=self.pres_l2_norm
            )
        if self.compute == "native":
            from .native import cpu_backend

            return cpu_backend.dec(
                np.asarray(x), self.wname, int(level), self.pres_l2_norm,
                self.precision,
            )
        y = self.plan.dec(jnp.asarray(x), int(level))
        if self.compute == "offload":
            y = np.asarray(y)
        return y

    # ------------------------------------------------------------------ rec
    def rec(self, y):
        if self.compute == "numpy":
            return _oracle.rec(np.asarray(y), self.wname, preserve_l2=self.pres_l2_norm)
        if self.compute == "native":
            from .native import cpu_backend

            return cpu_backend.rec(
                np.asarray(y), self.wname, self.pres_l2_norm, self.precision
            )
        x = self.plan.rec(jnp.asarray(y))
        if self.compute == "offload":
            x = np.asarray(x)
        return x

    def _prepare_input(self, x):
        return x


class nd_dwt_1D(_NdDwtBase):
    """1D NDDWT (reference: ``Functions/nd_dwt_1D.m``).

    Row vectors ``(1, N)`` are auto-transposed as in the reference
    (``Functions/nd_dwt_1D.m:151-153``). Unlike the reference (which errors
    on cell input, ``nd_dwt_1D.m:83-85``), a single-element list of wavelet
    names is accepted.
    """

    _NDIM = 1

    def __init__(self, wname, sizes, **options):
        if isinstance(wname, (list, tuple)) and len(wname) == 1:
            wname = wname[0]
        super().__init__(wname, sizes, **options)

    def _prepare_input(self, x):
        x = jnp.asarray(x) if self.compute in ("jax",) else np.asarray(x)
        if x.ndim == 2 and x.shape[0] == 1:
            x = x.reshape(-1)
        return x


class nd_dwt_2D(_NdDwtBase):
    """2D NDDWT (reference: ``Functions/nd_dwt_2D.m``); 4 bands/level."""

    _NDIM = 2


class nd_dwt_3D(_NdDwtBase):
    """3D NDDWT (reference: ``Functions/nd_dwt_3D.m``); 8 bands/level."""

    _NDIM = 3


class nd_dwt_4D(_NdDwtBase):
    """4D NDDWT (reference: ``Functions/nd_dwt_4D.m``); 16 bands/level.

    The reference's 4D-only ``method`` option (``'fft'|'conv'``,
    ``Functions/nd_dwt_4D.m:97,111-112``) is accepted: ``'fft'`` maps to the
    FFT path, ``'conv'`` to the working spatial-domain direct path (the
    reference's ``'conv'`` branch is vestigial/broken — 1D ``cconv`` applied
    to 4D arrays, ``Functions/nd_dwt_4D.m:427-442``).
    """

    _NDIM = 4

    def __init__(self, wname, sizes, **options):
        method = str(options.pop("method", "")).lower()
        if method == "conv":
            options.setdefault("path", "direct")
        elif method == "fft":
            options.setdefault("path", "fft")
        elif method:
            raise ValueError(f"Unknown method {method!r}: expected 'fft' or 'conv'")
        super().__init__(wname, sizes, **options)


class harr_nddwt_2D(_NdDwtBase):
    """2D Haar NDDWT via direct stencils (reference:
    ``Functions/harr_nddwt_2D.m`` — two-tap circular sums/differences).

    The wavelet is fixed to Haar/db1; multilevel ``dec`` is supported (the
    reference restricts ``dec`` to level 1, ``harr_nddwt_2D.m:136-138``).
    """

    _NDIM = 2
    _FORCE_PATH = "direct"

    def __init__(self, wname="db1", sizes=None, **options):
        if sizes is None:
            sizes = wname
            wname = "db1"
        if _first_name(wname) not in ("db1", "haar"):
            raise ValueError("harr_nddwt_2D supports only Haar (db1) filters")
        super().__init__("db1", sizes, **options)


class harr_nddwt_4D(_NdDwtBase):
    """4D Haar NDDWT via direct stencils (reference:
    ``Functions/harr_nddwt_4D.m`` — 16 unrolled two-tap stencil bands)."""

    _NDIM = 4
    _FORCE_PATH = "direct"

    def __init__(self, wname="db1", sizes=None, **options):
        if sizes is None:
            sizes = wname
            wname = "db1"
        if _first_name(wname) not in ("db1", "haar"):
            raise ValueError("harr_nddwt_4D supports only Haar (db1) filters")
        super().__init__("db1", sizes, **options)


def _first_name(wname) -> str:
    if isinstance(wname, (list, tuple)):
        wname = wname[0]
    return str(wname).lower()
