"""Sharded FFT path: pencil (slab) decomposition with ``all_to_all``.

The direct path (``parallel/sharded.py``) exchanges constant halos; the FFT
path instead needs each FFT'd axis fully local, so the classic pencil
scheme applies (SURVEY §5): FFT the local axes, ``all_to_all`` to rotate
which axis is sharded, FFT the remaining axis, multiply the cached
frequency responses, and mirror the dance on the way back.

Details:

* the whole multilevel cascade stays in the *transposed frequency domain* —
  the running approximation is never inverse-transformed between levels, so
  the per-level cost is one band multiply + the detail bands' inverse
  pencil pipeline (the frequency-domain cascade of ``ops/fft_path.py``,
  sharded);
* ``jax.lax.all_to_all(tiled=True)`` is the single collective used;
* per-device response slices are taken with ``axis_index`` dynamic slices
  (no gather).

Supported: ndim >= 2, spatial axis 0 sharded over ONE mesh axis, with both
``shape[0]`` and ``shape[1]`` divisible by the mesh axis size. It is the
reference's core algorithm (``mex/nddwt.c:15-61``) sharded, and the path
that suits long filters and deep levels; the direct-path ``ShardedNDDWT``
serves short filters.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..oracle import level_from_bands, num_bands
from ..plan import NDDWT


def _local_resp(resp_axis, axis_name, local_n):
    """Device-local slice of one axis' (2, N) frequency response."""
    idx = jax.lax.axis_index(axis_name)
    return jax.lax.dynamic_slice_in_dim(resp_axis, idx * local_n, local_n, axis=1)


def _apply_axis_resp(T, resp_axis, sel, spatial_axis):
    """Multiply band-stacked spectrum T by one axis' lo/hi response row."""
    f = resp_axis[sel]
    shape = [1] * T.ndim
    shape[spatial_axis] = f.shape[0]
    return T * f.reshape(shape)


def _band_expand(Xf, resp_list):
    """(…spatial) -> (2^d, …spatial); bit k of the band index = H on axis k.

    ``resp_list[k]`` is the (2, local_n_k) response for *array* axis k of
    ``Xf`` (already device-local where sharded).
    """
    d = Xf.ndim
    T = Xf[None]
    for ax in range(d):
        lo = _apply_axis_resp(T, resp_list[ax], 0, 1 + ax)
        hi = _apply_axis_resp(T, resp_list[ax], 1, 1 + ax)
        T = jnp.concatenate([lo, hi], axis=0)
    return T


def _band_collapse(Yf, resp_list):
    """Adjoint of :func:`_band_expand`: (2^d, …) -> (…), conj responses."""
    d = Yf.ndim - 1
    T = Yf
    for ax in reversed(range(d)):
        nb = T.shape[0]
        lo, hi = T[: nb // 2], T[nb // 2 :]
        cl = jnp.conj(resp_list[ax][0])
        ch = jnp.conj(resp_list[ax][1])
        shape = [1] * lo.ndim
        shape[1 + ax] = cl.shape[0]
        T = lo * cl.reshape(shape) + hi * ch.reshape(shape)
    return T[0]


class ShardedFFTNDDWT:
    """FFT-path NDDWT with spatial axis 0 sharded over one mesh axis.

    API mirrors ``ShardedNDDWT``: band-first ``(B, *spatial)`` arrays with
    the band axis unsharded.
    """

    def __init__(self, plan: NDDWT, mesh: Mesh, axis_name: str = "x"):
        if plan.ndim < 2:
            raise ValueError("pencil FFT sharding needs ndim >= 2")
        if axis_name not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis_name!r}")
        psize = mesh.shape[axis_name]
        if plan.shape[0] % psize or plan.shape[1] % psize:
            raise ValueError(
                f"shape[0] ({plan.shape[0]}) and shape[1] ({plan.shape[1]}) "
                f"must divide by mesh axis {axis_name!r} ({psize})"
            )
        self.plan = plan
        self.mesh = mesh
        self.axis_name = axis_name
        self.psize = psize
        spatial = (axis_name,) + (None,) * (plan.ndim - 1)
        self.x_spec = P(*spatial)
        self.y_spec = P(None, *spatial)
        self.x_sharding = NamedSharding(mesh, self.x_spec)
        self.y_sharding = NamedSharding(mesh, self.y_spec)
        self._dec_cache = {}
        self._rec_cache = {}

    # ------------------------------------------------------------ internals
    def _fwd_pencil(self, x_local):
        """Local slab -> fully-FFT'd, axis-1-sharded pencil spectrum."""
        d = x_local.ndim
        ax_name = self.axis_name
        Xf = jnp.fft.fftn(x_local, axes=tuple(range(1, d)))
        # (n0/P, n1, rest) -> (n0, n1/P, rest)
        Xt = jax.lax.all_to_all(
            Xf, ax_name, split_axis=1, concat_axis=0, tiled=True
        )
        return jnp.fft.fft(Xt, axis=0)

    def _inv_pencil(self, T):
        """Inverse of :func:`_fwd_pencil` for band-stacked arrays (B, ...)."""
        d = T.ndim - 1
        ax_name = self.axis_name
        T = jnp.fft.ifft(T, axis=1)  # spatial axis 0 (local in pencil form)
        T = jax.lax.all_to_all(
            T, ax_name, split_axis=1, concat_axis=2, tiled=True
        )
        return jnp.fft.ifftn(T, axes=tuple(range(2, d + 1)))

    def _resp_pencil(self, cdtype):
        """Responses in pencil coordinates: axis0 full, axis1 local slice."""
        resp = [jnp.asarray(r, cdtype) for r in self.plan.resp]
        local1 = self.plan.shape[1] // self.psize
        out = [resp[0], _local_resp(resp[1], self.axis_name, local1)]
        out.extend(resp[2:])
        return out

    # ------------------------------------------------------------------ dec
    def dec_fn(self, level: int):
        level = int(level)
        if level in self._dec_cache:
            return self._dec_cache[level]
        plan = self.plan
        cdtype = plan.complex_dtype

        def body(x_local):
            real_in = not jnp.iscomplexobj(x_local)
            Xf = self._fwd_pencil(x_local.astype(cdtype))
            resp_p = self._resp_pencil(cdtype)
            groups = []
            approx_f = Xf
            for _ in range(level):
                bands_f = _band_expand(approx_f, resp_p)
                approx_f = bands_f[0]
                groups.append(bands_f[1:])
            parts = [self._inv_pencil(approx_f[None])]
            for g in reversed(groups):
                parts.append(self._inv_pencil(g))
            y = jnp.concatenate(parts, axis=0)
            return y.real.astype(plan.real_dtype) if real_in else y

        mapped = jax.shard_map(
            body, mesh=self.mesh, in_specs=(self.x_spec,), out_specs=self.y_spec
        )
        fn = jax.jit(mapped)
        self._dec_cache[level] = fn
        return fn

    def dec(self, x, level: int):
        return self.dec_fn(level)(x)

    # ------------------------------------------------------------------ rec
    def rec_fn(self, level: int):
        level = int(level)
        if level in self._rec_cache:
            return self._rec_cache[level]
        plan = self.plan
        cdtype = plan.complex_dtype
        nb = 2**plan.ndim

        def fwd_bands(y_local):
            d = y_local.ndim - 1
            Yf = jnp.fft.fftn(y_local, axes=tuple(range(2, d + 1)))
            Yt = jax.lax.all_to_all(
                Yf, self.axis_name, split_axis=2, concat_axis=1, tiled=True
            )
            return jnp.fft.fft(Yt, axis=1)

        def body(y_local):
            real_in = not jnp.iscomplexobj(y_local)
            Yf = fwd_bands(y_local.astype(cdtype))
            resp_p = self._resp_pencil(cdtype)

            def synth(group_f):
                acc = _band_collapse(group_f, resp_p)
                if not plan.preserve_l2:
                    acc = acc / nb
                return acc

            acc_f = synth(Yf[:nb])
            pos = nb
            for _ in range(1, level):
                group = jnp.concatenate([acc_f[None], Yf[pos : pos + nb - 1]], axis=0)
                acc_f = synth(group)
                pos += nb - 1
            x = self._inv_pencil(acc_f[None])[0]
            return x.real.astype(plan.real_dtype) if real_in else x

        mapped = jax.shard_map(
            body, mesh=self.mesh, in_specs=(self.y_spec,), out_specs=self.x_spec
        )
        fn = jax.jit(mapped)
        self._rec_cache[level] = fn
        return fn

    def rec(self, y):
        level = level_from_bands(self.plan.ndim, y.shape[0])
        return self.rec_fn(level)(y)

    # ------------------------------------------------------------- helpers
    def shard_input(self, x):
        return jax.device_put(x, self.x_sharding)

    def num_bands(self, level: int) -> int:
        return num_bands(self.plan.ndim, level)
