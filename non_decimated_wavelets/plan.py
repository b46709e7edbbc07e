"""Transform plan: validated config + device-cached filter bank + dec/rec.

The reference's core design decision — precompute the filter bank once in the
constructor so repeated ``dec``/``rec`` calls in iterative algorithms are
cheap (``README.md:2``, ``Functions/nd_dwt_2D.m:1-4``) — carried over: an
:class:`NDDWT` plan owns per-axis frequency responses (FFT path) and
correlation taps (direct path) as host constants, plus jitted,
shape-static transform callables.

Unlike the reference's four near-copy classes (``Functions/nd_dwt_{1,2,3,4}D.m``),
the plan is dimension-generic (like the reference's MEX core,
``mex/nddwt.c:98-99``) and works for any ndim >= 1.
"""

from __future__ import annotations

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np

from . import filters as _filters
from . import oracle as _oracle
from .models.denoise import shrink_details, soft_threshold_mag_pair
from .ops import direct_path, fft_path

_VALID_PATHS = ("auto", "fft", "direct")
_REAL_DTYPES = {
    "float32": jnp.float32,
    "float64": jnp.float64,
    "single": jnp.float32,
    "double": jnp.float64,
    "bfloat16": jnp.bfloat16,
    "bf16": jnp.bfloat16,
}


def _as_real_dtype(dtype) -> jnp.dtype:
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _REAL_DTYPES:
            dt = _REAL_DTYPES[key]
        else:
            dt = jnp.dtype(dtype)
    else:
        dt = jnp.dtype(dtype)
    dt = jnp.dtype(dt)
    if dt not in (
        jnp.dtype(jnp.float32),
        jnp.dtype(jnp.float64),
        jnp.dtype(jnp.bfloat16),
    ):
        raise ValueError(
            "precision must be float32/float64/bfloat16 "
            f"('single'/'double'/'bf16'), got {dtype!r}"
        )
    if dt == jnp.dtype(jnp.float64) and not jax.config.read("jax_enable_x64"):
        raise ValueError(
            "float64 requested but jax_enable_x64 is off; "
            "set JAX_ENABLE_X64=1 or jax.config.update('jax_enable_x64', True)"
        )
    return dt


@dataclasses.dataclass(frozen=True)
class NDDWT:
    """Plan for a multidimensional non-decimated DWT.

    Parameters mirror the reference constructors
    (``Functions/nd_dwt_1D.m:79-133``): ``wavelet`` is one name or one per
    axis; ``shape`` the spatial extents; ``preserve_l2`` the tight-frame
    normalization (``pres_l2_norm``); ``dtype`` the precision
    (``'single'``/``'double'`` accepted); ``path`` selects the compute
    strategy (the counterpart of the reference's ``compute`` option):

    * ``'fft'``    — frequency-domain fast convolution (XLA FFT);
    * ``'direct'`` — spatial-domain circular stencils (Haar-class pattern
      generalized);
    * ``'auto'``   — pick per (filter length, dtype); see
      :meth:`_resolve_path`.
    """

    wavelet: object
    shape: tuple
    preserve_l2: bool = False
    dtype: object = jnp.float32
    path: str = "auto"

    # Derived/cached fields (filled in __post_init__).
    wavelets: tuple = dataclasses.field(init=False)
    ndim: int = dataclasses.field(init=False)
    real_dtype: object = dataclasses.field(init=False)
    complex_dtype: object = dataclasses.field(init=False)
    resp: tuple = dataclasses.field(init=False, repr=False)
    taps: tuple = dataclasses.field(init=False, repr=False)
    filter_lengths: tuple = dataclasses.field(init=False)

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        if len(shape) < 1:
            raise ValueError("shape must have at least one axis")
        if any(s < 1 for s in shape):
            raise ValueError(f"invalid shape {shape}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "ndim", len(shape))
        wavelets = _oracle._normalize_wavelets(self.wavelet, len(shape))
        object.__setattr__(self, "wavelets", wavelets)
        if self.path not in _VALID_PATHS:
            raise ValueError(f"path must be one of {_VALID_PATHS}, got {self.path!r}")

        rdt = _as_real_dtype(self.dtype)
        cdt = (
            jnp.complex128
            if rdt == jnp.dtype(jnp.float64)
            else jnp.complex64  # f32 and bf16 both promote to c64
        )
        object.__setattr__(self, "real_dtype", rdt)
        object.__setattr__(self, "complex_dtype", cdt)

        scale = 1.0 / np.sqrt(2.0) if self.preserve_l2 else 1.0
        # Stored as host NumPy arrays: they are tiny, hashable into jit
        # traces as constants, and avoid device->host round trips when a
        # transform is traced inside an outer jit.
        # ``taps`` are in the compute dtype: a bf16 plan stores bf16 arrays
        # but correlates with f32 taps and f32 accumulation (the direct
        # path upcasts inside the fusion). Taps quantized to bf16 (~3
        # digits) would break the frame property at that level.
        tap_dt = np.float32 if rdt == jnp.dtype(jnp.bfloat16) else rdt
        resp, taps, flens = [], [], []
        for w, n in zip(wavelets, shape):
            F = _filters.frequency_response(w, n)  # validates K <= n
            lo, hi = _filters.correlation_taps(w)
            flens.append(len(lo))
            resp.append(np.asarray(scale * F, dtype=cdt))
            taps.append(np.asarray(scale * np.stack([lo, hi]), dtype=tap_dt))
        object.__setattr__(self, "resp", tuple(resp))
        object.__setattr__(self, "taps", tuple(taps))
        object.__setattr__(self, "filter_lengths", tuple(flens))

    # ------------------------------------------------------------------ paths
    def _resolve_path(self) -> str:
        """The compute path: an explicit ``path`` is honoured; ``'auto'``
        picks ``'direct'`` for float64 and for filters of at most 12 taps,
        ``'fft'`` above that. The rule is the same on every backend."""
        if self.path != "auto":
            return self.path
        if self.real_dtype == jnp.dtype(jnp.float64):
            return "direct"
        return "direct" if max(self.filter_lengths) <= 12 else "fft"

    # ------------------------------------------------------------------- dec
    def dec(self, x, level: int, band_axis: int = -1):
        """Multilevel analysis. ``band_axis=-1`` gives the reference layout
        ``[n1..nd, B]`` (``Functions/nd_dwt_1D.m:43-49``); ``0`` gives the
        band-first layout ``[B, n1..nd]``, which needs no transpose."""
        level = int(level)
        if level < 1:
            raise ValueError(f"level must be >= 1, got {level}")
        x = jnp.asarray(x)
        if x.shape != self.shape:
            raise ValueError(
                f"input shape {x.shape} does not match plan shape {self.shape}"
            )
        is_complex = jnp.iscomplexobj(x)
        x = x.astype(self.complex_dtype if is_complex else self.real_dtype)
        path = self._resolve_path()
        with jax.named_scope(f"nddwt.dec.{path}.L{level}"):
            if path == "fft":
                y = fft_path.dec_fft(x, self.resp, level, real_out=not is_complex)
            else:
                y = direct_path.dec_direct(x, self.taps, level)
        # Pin the plan dtype: the FFT path computes in complex64/128, whose
        # .real is f32/f64 — a bf16 plan must still return bf16 bands.
        y = y.astype(self.complex_dtype if is_complex else self.real_dtype)
        if band_axis in (-1, y.ndim - 1):
            y = jnp.moveaxis(y, 0, -1)
        elif band_axis != 0:
            raise ValueError("band_axis must be 0 or -1")
        return y

    # ------------------------------------------------------------------- rec
    def rec(self, y, band_axis: int = -1):
        """Multilevel synthesis; level inferred from the band count
        (``Functions/nd_dwt_3D.m:217``)."""
        y = jnp.asarray(y)
        if y.ndim != self.ndim + 1:
            raise ValueError(
                f"expected {self.ndim + 1}-D band array, got {y.ndim}-D"
            )
        if band_axis in (-1, y.ndim - 1):
            y = jnp.moveaxis(y, -1, 0)
        elif band_axis != 0:
            raise ValueError("band_axis must be 0 or -1")
        if y.shape[1:] != self.shape:
            raise ValueError(
                f"band array spatial shape {y.shape[1:]} does not match plan "
                f"shape {self.shape}"
            )
        level = _oracle.level_from_bands(self.ndim, y.shape[0])
        is_complex = jnp.iscomplexobj(y)
        y = y.astype(self.complex_dtype if is_complex else self.real_dtype)
        path = self._resolve_path()
        with jax.named_scope(f"nddwt.rec.{path}.L{level}"):
            if path == "fft":
                x = fft_path.rec_fft(
                    y, self.resp, level, self.preserve_l2, real_out=not is_complex
                )
            else:
                x = direct_path.rec_direct(y, self.taps, level, self.preserve_l2)
        return x.astype(self.complex_dtype if is_complex else self.real_dtype)

    # ------------------------------------------------------- fused iterate
    def dec_rec(self, x, level: int, threshold: float = 0.0,
                band_axis: int = -1):
        """One analysis -> soft-threshold(details) -> synthesis iterate;
        returns ``(bands, reconstruction)``.

        This is the inner loop of every iterative algorithm the reference
        was built for (``README.md:2``): with ``threshold=0`` it is the
        plain round-trip pair, with ``threshold>0`` the cycle-spinning
        denoise / FISTA prox step. ``threshold`` may be a traced scalar.
        """
        y = self.dec(x, level, band_axis=0)
        if not isinstance(threshold, (int, float)) or threshold:
            y = shrink_details(y, threshold)
        xr = self.rec(y, band_axis=0)
        if band_axis in (-1, y.ndim - 1):
            y = jnp.moveaxis(y, 0, -1)
        elif band_axis != 0:
            raise ValueError("band_axis must be 0 or -1")
        return y, xr

    def dec_rec_n(self, x, level: int, thresholds):
        """N ``dec -> soft-threshold -> rec`` sweeps; returns the
        reconstruction after the last sweep. ``thresholds`` is the
        per-sweep threshold schedule (one float per sweep). The sweeps run
        as one ``lax.scan``, so a jitted caller compiles one iterate."""
        level = int(level)
        if level < 1:
            raise ValueError(f"level must be >= 1, got {level}")
        thresholds = tuple(float(t) for t in thresholds)
        if not thresholds:
            raise ValueError("thresholds must contain at least one sweep")
        x = jnp.asarray(x)
        if x.shape != self.shape:
            raise ValueError(
                f"input shape {x.shape} does not match plan shape {self.shape}"
            )
        if jnp.iscomplexobj(x):
            raise ValueError(
                "dec_rec_n is real-only; split complex data and use the "
                "split entry points"
            )
        x = x.astype(self.real_dtype)

        def sweep(v, lam):
            return self.dec_rec(v, level, threshold=lam, band_axis=0)[1], None

        with jax.named_scope(f"nddwt.dec_rec_n.L{level}x{len(thresholds)}"):
            x, _ = jax.lax.scan(
                sweep, x, jnp.asarray(thresholds, self.taps[0].dtype)
            )
        return x

    # --------------------------------------------------------------- batched
    def dec_batched(self, x, level: int):
        """Analysis of a batch of arrays: ``(N, *shape) -> (N, B, *shape)``
        (band-first per item).

        The reference transforms one array per call; batched use (multi-coil
        MRI, cycle spinning over shifts, ensembles) re-enters MATLAB per
        item. Here the whole batch is one traced program: the direct path
        carries the batch axis natively, the FFT path under ``vmap``.
        """
        level = int(level)
        if level < 1:
            raise ValueError(f"level must be >= 1, got {level}")
        x = jnp.asarray(x)
        if x.ndim != self.ndim + 1 or x.shape[1:] != self.shape or x.shape[0] < 1:
            raise ValueError(
                f"expected (N, *{self.shape}) batch with N >= 1, got {x.shape}"
            )
        is_complex = jnp.iscomplexobj(x)
        x = x.astype(self.complex_dtype if is_complex else self.real_dtype)
        path = self._resolve_path()
        with jax.named_scope(f"nddwt.dec_batched.{path}.L{level}"):
            if path == "fft":
                return jax.vmap(
                    lambda v: fft_path.dec_fft(
                        v, self.resp, level, real_out=not is_complex
                    )
                )(x).astype(x.dtype)
            # direct path correlates the trailing ndim axes: batch native
            y = direct_path.dec_direct(x, self.taps, level)  # (B, N, *s)
            return jnp.swapaxes(y, 0, 1)

    def rec_batched(self, y):
        """Synthesis of a batch: ``(N, B, *shape) -> (N, *shape)``."""
        y = jnp.asarray(y)
        if y.ndim != self.ndim + 2 or y.shape[2:] != self.shape or y.shape[0] < 1:
            raise ValueError(
                f"expected (N, B, *{self.shape}) batch of band arrays with "
                f"N >= 1, got {y.shape}"
            )
        level = _oracle.level_from_bands(self.ndim, y.shape[1])
        is_complex = jnp.iscomplexobj(y)
        y = y.astype(self.complex_dtype if is_complex else self.real_dtype)
        path = self._resolve_path()
        with jax.named_scope(f"nddwt.rec_batched.{path}.L{level}"):
            if path == "fft":
                return jax.vmap(
                    lambda v: fft_path.rec_fft(
                        v, self.resp, level, self.preserve_l2,
                        real_out=not is_complex,
                    )
                )(y).astype(y.dtype)
            yb = jnp.swapaxes(y, 0, 1)  # (B, N, *shape)
            return direct_path.rec_direct(
                yb, self.taps, level, self.preserve_l2
            )

    # ---------------------------------------------------------- split-complex
    def dec_split(self, x_pair, level: int):
        """Analysis of complex data in split re/im form: (2, *shape) real ->
        (2, B, *shape) real, band-first.

        The filters are real, so the real and imaginary parts transform
        independently. Numerically identical to ``dec`` on
        ``x_pair[0] + 1j*x_pair[1]``.
        """
        x_pair = jnp.asarray(x_pair, self.real_dtype)
        if x_pair.shape != (2,) + self.shape:
            raise ValueError(
                f"expected (2, *{self.shape}) split re/im array, got "
                f"{x_pair.shape}"
            )
        level = int(level)
        path = self._resolve_path()
        with jax.named_scope(f"nddwt.dec_split.{path}.L{level}"):
            if path == "fft":
                f = lambda v: fft_path.dec_fft(v, self.resp, level,
                                               real_out=True)
                return jnp.stack(
                    [f(x_pair[0]), f(x_pair[1])]
                ).astype(self.real_dtype)
            # direct path handles a leading batch dim natively
            y = direct_path.dec_direct(x_pair, self.taps, level)
            return jnp.swapaxes(y, 0, 1)

    def rec_split(self, y_pair):
        """Synthesis from split re/im bands: (2, B, *shape) -> (2, *shape)."""
        y_pair = jnp.asarray(y_pair, self.real_dtype)
        if y_pair.ndim != self.ndim + 2 or y_pair.shape[0] != 2:
            raise ValueError(
                f"expected (2, B, *{self.shape}) split band array, got "
                f"{y_pair.shape}"
            )
        level = _oracle.level_from_bands(self.ndim, y_pair.shape[1])
        path = self._resolve_path()
        with jax.named_scope(f"nddwt.rec_split.{path}.L{level}"):
            if path == "fft":
                f = lambda v: fft_path.rec_fft(
                    v, self.resp, level, self.preserve_l2, real_out=True
                )
                return jnp.stack(
                    [f(y_pair[0]), f(y_pair[1])]
                ).astype(self.real_dtype)
            y = jnp.swapaxes(y_pair, 0, 1)  # (B, 2, *shape)
            return direct_path.rec_direct(y, self.taps, level, self.preserve_l2)

    def dec_rec_split(self, x_pair, level: int, threshold: float = 0.0):
        """One split-complex iterate: analysis -> complex-magnitude
        soft-threshold (the prox of the complex l1 norm — joint re/im, the
        reference's MRI use case, ``Functions/nd_dwt_1D.m:57-61``) ->
        synthesis. Returns ``((2, B, *shape) bands, (2, *shape) recon)``."""
        level = int(level)
        if level < 1:
            raise ValueError(f"level must be >= 1, got {level}")
        y = self.dec_split(x_pair, level)
        if threshold:
            y = soft_threshold_mag_pair(y, threshold)
        return y, self.rec_split(y)

    # ------------------------------------------------------------ convenience
    def num_bands(self, level: int) -> int:
        return _oracle.num_bands(self.ndim, level)

    # The reference's only persistent state is the in-memory filter cache,
    # rebuilt on construction (``Functions/nd_dwt_1D.m:68``); likewise a
    # plan round-trips through its five config fields.
    def to_config(self) -> dict:
        return {
            "wavelet": list(self.wavelets),
            "shape": list(self.shape),
            "preserve_l2": bool(self.preserve_l2),
            "dtype": str(jnp.dtype(self.real_dtype)),
            "path": self.path,
        }

    @classmethod
    def from_config(cls, cfg: dict) -> "NDDWT":
        return cls(
            wavelet=tuple(cfg["wavelet"]),
            shape=tuple(cfg["shape"]),
            preserve_l2=cfg.get("preserve_l2", False),
            dtype=cfg.get("dtype", "float32"),
            path=cfg.get("path", "auto"),
        )
