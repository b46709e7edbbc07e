"""Multi-device spatial decomposition for the non-decimated DWT.

The reference's only scaling axis is shared-memory threading (8 hard-coded
FFTW threads, ``mex/nddwt.c:103``; OpenMP pointwise multiply,
``mex/nddwt.c:73``). Here the scaling axis is *spatial-domain
decomposition* over a ``jax.sharding.Mesh``: spatial axes of the volume are
sharded across devices, and each K-tap circular-correlation axis pass
exchanges a constant ``K-1``-sample periodic halo with its neighbors along
that mesh axis via ``jax.lax.ppermute`` — the circular wrap of the periodic
boundary condition maps onto a logical ring (first and last shard linked).

Because the reference's cascade re-filters the full-resolution approximation
with *undilated* filters every level (``Functions/nd_dwt_1D.m:181``), the
halo width is constant across levels — no growing overlap.

Collectives used: ``ppermute`` only (the halo exchange; on GPUs XLA hands
it to NCCL, and every card reaches every other at the same rate, so the
mesh follows the algorithm alone); ``psum`` appears only in tests. All communication is expressed inside a
single ``jax.shard_map`` region per transform so XLA can overlap the halo
transfers with the interior stencil computation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.denoise import shrink_details, soft_threshold_mag_pair
from ..oracle import level_from_bands, num_bands
from ..ops import direct_path
from ..plan import NDDWT


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Build a Mesh from {axis_name: size}; devices default to all."""
    if devices is None:
        devices = jax.devices()
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes[n] for n in names)
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(
            f"mesh needs {total} devices, only {len(devices)} available"
        )
    arr = np.array(devices[:total]).reshape(sizes)
    return Mesh(arr, names)


# --------------------------------------------------------------------------
# Halo-exchanged axis passes (run inside shard_map).
# --------------------------------------------------------------------------


def _ring_perms(P_: int):
    fwd = [(i, (i + 1) % P_) for i in range(P_)]
    bwd = [(i, (i - 1) % P_) for i in range(P_)]
    return fwd, bwd


def _halo_pad(x, axis, axis_name, left_w, right_w):
    """Concatenate periodic halos from ring neighbors along ``axis``.

    ``left_w`` samples come from the left neighbor's tail, ``right_w`` from
    the right neighbor's head; with a single shard this degenerates to the
    local circular wrap.
    """
    size = jax.lax.axis_size(axis_name)
    n = x.shape[axis]
    parts = []
    if left_w:
        tail = jax.lax.slice_in_dim(x, n - left_w, n, axis=axis)
        if size > 1:
            fwd, _ = _ring_perms(size)
            tail = jax.lax.ppermute(tail, axis_name, fwd)
        parts.append(tail)
    parts.append(x)
    if right_w:
        head = jax.lax.slice_in_dim(x, 0, right_w, axis=axis)
        if size > 1:
            _, bwd = _ring_perms(size)
            head = jax.lax.ppermute(head, axis_name, bwd)
        parts.append(head)
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else x


def _corr_pair_halo(x, taps, axis, axis_name):
    """Sharded-axis analysis pass: y_c[n] = sum_j t[j] x[n + j - o]."""
    K = taps.shape[1]
    o = K // 2 - 1
    n = x.shape[axis]
    xp = _halo_pad(x, axis, axis_name, left_w=o, right_w=K - 1 - o)
    acc_lo = None
    acc_hi = None
    for j in range(K):
        sl = jax.lax.slice_in_dim(xp, j, j + n, axis=axis)
        tl = taps[0, j] * sl
        th = taps[1, j] * sl
        acc_lo = tl if acc_lo is None else acc_lo + tl
        acc_hi = th if acc_hi is None else acc_hi + th
    return acc_lo, acc_hi


def _adj_pair_halo(lo, hi, taps, axis, axis_name):
    """Sharded-axis synthesis pass: x[m] = sum_j t[j] y[m - j + o]."""
    K = taps.shape[1]
    o = K // 2 - 1
    n = lo.shape[axis]
    # m - j + o ranges over [m - (K-1-o), m + o]
    lp = _halo_pad(lo, axis, axis_name, left_w=K - 1 - o, right_w=o)
    hp = _halo_pad(hi, axis, axis_name, left_w=K - 1 - o, right_w=o)
    acc = None
    for j in range(K):
        # padded index for output m: m + (K-1-o) - j + o - ... careful:
        # y[m - j + o] lives at padded position m + (K-1-o) + o - j.
        start = K - 1 - j
        sl = taps[0, j] * jax.lax.slice_in_dim(lp, start, start + n, axis=axis)
        sh = taps[1, j] * jax.lax.slice_in_dim(hp, start, start + n, axis=axis)
        term = sl + sh
        acc = term if acc is None else acc + term
    return acc


# Unsharded-axis passes reuse the single-device circular pad+slice forms:
# the halo'd passes above are the same stencils with the pad sourced from
# ring neighbors instead of the local wrap.
_corr_pair_local = direct_path._corr_pair
_adj_pair_local = direct_path._adj_pair


# --------------------------------------------------------------------------
# Sharded multilevel transform (the body passed to shard_map).
# --------------------------------------------------------------------------


def _level1_dec_sharded(x, taps, axis_names):
    """(2^d, *local spatial) bands; ``axis_names[k]`` is the mesh axis
    sharding spatial axis k (or None)."""
    ndim = len(taps)
    T = x[None].astype(direct_path.compute_dtype(x.dtype, taps))
    for ax in range(ndim):
        sp_axis = T.ndim - ndim + ax
        if axis_names[ax] is None:
            lo, hi = _corr_pair_local(T, taps[ax], sp_axis)
        else:
            lo, hi = _corr_pair_halo(T, taps[ax], sp_axis, axis_names[ax])
        T = jnp.concatenate([lo, hi], axis=0)
    return T


def _level1_rec_sharded(group, taps, axis_names):
    ndim = len(taps)
    T = group.astype(direct_path.compute_dtype(group.dtype, taps))
    for ax in reversed(range(ndim)):
        nb = T.shape[0]
        sp_axis = T.ndim - ndim + ax
        lo, hi = T[: nb // 2], T[nb // 2 :]
        if axis_names[ax] is None:
            T = _adj_pair_local(lo, hi, taps[ax], sp_axis)
        else:
            T = _adj_pair_halo(lo, hi, taps[ax], sp_axis, axis_names[ax])
    return T[0]


def _dec_body(x, taps, level, axis_names):
    groups = []
    approx = x
    for _ in range(level):
        bands = _level1_dec_sharded(approx, taps, axis_names).astype(x.dtype)
        approx = bands[0]
        groups.append(bands[1:])
    parts = [approx[None]]
    for g in reversed(groups):
        parts.append(g)
    return jnp.concatenate(parts, axis=0)


def _rec_body(y, taps, level, preserve_l2, axis_names):
    ndim = len(taps)
    nb = 2**ndim

    def synth(group):
        acc = _level1_rec_sharded(group, taps, axis_names)
        if not preserve_l2:
            acc = acc / nb
        return acc.astype(y.dtype)

    acc = synth(y[:nb])
    pos = nb
    for _ in range(1, level):
        group = jnp.concatenate([acc[None], y[pos : pos + nb - 1]], axis=0)
        acc = synth(group)
        pos += nb - 1
    return acc


def _streamed_pair(x, dec_approx, dec_full, rec1, level):
    """Level-streamed fused iterate: dec -> shrink(details) -> rec with the
    cascade re-ordered so the full ``(B, *local)`` band array is NEVER
    materialized — the memory layout that makes BASELINE config #5
    (512^3 x 64 db4 L3: a 1.58 TB band array) tractable (SURVEY §7 hard
    part 4; DESIGN.md "Config #5 memory layout").

    Structure: recompute-on-the-way-up. Descending, only the running
    approximation is computed (``dec_approx``); ascending, each level's
    full band set is (re)computed, its details shrunk, and the
    level synthesized immediately (``dec_full`` + ``rec1``). Peak live
    bands = ONE level's ``2^d`` plus the ``level`` retained approximations
    — ``(level + 2^d + O(1)) x numel`` instead of ``(B + O(1)) x numel``.
    Cost: one extra analysis pass per non-deepest level (~+25% pair FLOPs
    at 4D L3), the classic rematerialization trade."""

    def go(a, lvl):
        if lvl == level - 1:
            bands = dec_full(a)
            deep = bands[0]
        else:
            deep = go(dec_approx(a), lvl + 1)
            bands = dec_full(a)
        return rec1(jnp.concatenate([deep[None], bands[1:]], axis=0))

    return go(x, 0)


class ShardedNDDWT:
    """A plan bound to a mesh and a spatial partitioning.

    ``spec`` maps each spatial axis to a mesh axis name or ``None``
    (replicated/local), e.g. ``('x', 'y', None)`` for a 3D volume sharded
    over a 2D mesh. Band arrays are band-first ``(B, *spatial)`` with the
    band axis unsharded (each device holds all bands of its spatial tile —
    the right layout for thresholding/recon loops, which are pointwise in
    space).

    Shard sizes must divide evenly (``shard_map`` constraint); the plan
    validates this at construction.
    """

    def __init__(self, plan: NDDWT, mesh: Mesh, spec, batch_spec=()):
        spec = tuple(spec)
        batch_spec = tuple(batch_spec)
        if len(spec) != plan.ndim:
            raise ValueError(
                f"spec must name {plan.ndim} spatial axes, got {len(spec)}"
            )
        for ax, name in enumerate(spec):
            if name is None:
                continue
            if name not in mesh.shape:
                raise ValueError(f"mesh has no axis {name!r}")
            psize = mesh.shape[name]
            if plan.shape[ax] % psize:
                raise ValueError(
                    f"spatial axis {ax} (size {plan.shape[ax]}) not divisible "
                    f"by mesh axis {name!r} (size {psize})"
                )
            local = plan.shape[ax] // psize
            # The halo-exchange body needs max(K//2, K//2-1) = K//2 rows
            # from each ring neighbor.
            halo = plan.filter_lengths[ax] // 2
            if local < halo:
                raise ValueError(
                    f"local shard of axis {ax} ({local}) is smaller than the "
                    f"filter halo ({halo}); use fewer shards or shorter filters"
                )
        self.plan = plan
        self.mesh = mesh
        self.spec = spec
        self.batch_spec = batch_spec
        self.x_spec = P(*batch_spec, *spec)
        self.y_spec = P(None, *batch_spec, *spec)
        self.x_sharding = NamedSharding(mesh, self.x_spec)
        self.y_sharding = NamedSharding(mesh, self.y_spec)
        self._dec_cache = {}
        self._rec_cache = {}

        self._local_shape = tuple(
            plan.shape[ax] // (mesh.shape[spec[ax]] if spec[ax] else 1)
            for ax in range(plan.ndim)
        )

    def _jit(self, body, in_spec, out_specs):
        """``jit(shard_map(body))`` with the plan's taps as a replicated
        second operand."""
        mapped = jax.shard_map(
            body, mesh=self.mesh, in_specs=(in_spec, P()), out_specs=out_specs
        )
        return jax.jit(lambda v: mapped(v, self.plan.taps))

    # ------------------------------------------------------------------ dec
    def dec_fn(self, level: int):
        """Jitted sharded analysis: (sharded x) -> (B, *spatial) sharded."""
        level = int(level)
        if level not in self._dec_cache:
            body = partial(_dec_body, level=level, axis_names=self.spec)
            self._dec_cache[level] = self._jit(body, self.x_spec, self.y_spec)
        return self._dec_cache[level]

    def dec(self, x, level: int):
        return self.dec_fn(level)(x)

    # ------------------------------------------------------------------ rec
    def rec_fn(self, level: int):
        level = int(level)
        if level not in self._rec_cache:
            body = partial(
                _rec_body,
                level=level,
                preserve_l2=self.plan.preserve_l2,
                axis_names=self.spec,
            )
            self._rec_cache[level] = self._jit(body, self.y_spec, self.x_spec)
        return self._rec_cache[level]

    def rec(self, y):
        level = level_from_bands(self.plan.ndim, y.shape[0])
        return self.rec_fn(level)(y)

    # --------------------------------------------------------- fused iterate
    def dec_rec_fn(self, level: int, threshold: float = 0.0):
        """Jitted sharded iterate: analysis -> soft-threshold(details) ->
        synthesis in ONE ``shard_map`` region, returning ``(bands, x)`` —
        the sharded counterpart of ``NDDWT.dec_rec``."""
        level = int(level)
        threshold = float(threshold)
        key = ("pair", level, threshold)
        if key not in self._dec_cache:

            def body(x, taps):
                y = _dec_body(x, taps, level, self.spec)
                if threshold:
                    y = shrink_details(y, threshold)
                xr = _rec_body(
                    y, taps, level, self.plan.preserve_l2, self.spec
                )
                return y, xr

            self._dec_cache[key] = self._jit(
                body, self.x_spec, (self.y_spec, self.x_spec)
            )
        return self._dec_cache[key]

    def dec_rec(self, x, level: int, threshold: float = 0.0):
        return self.dec_rec_fn(level, threshold)(x)

    # ------------------------------------------------- level-streamed iterate
    def dec_rec_streamed_fn(self, level: int, threshold: float = 0.0):
        """Jitted level-streamed fused iterate ``x -> reconstruction``
        (bands are never returned — not materializing them is the point).

        This is the BASELINE-config-#5 memory layout (see
        :func:`_streamed_pair` and DESIGN.md): per-device peak band memory
        is ``(level + 2^d + O(1))`` local volumes instead of
        ``B + O(1) = 2^d + (2^d-1)(level-1) + O(1)`` — for 4D db4 L3,
        ~25x the local volume instead of ~51x, at ~+25% analysis FLOPs.
        Use :meth:`dec_rec` when the band array is needed or fits."""
        level = int(level)
        threshold = float(threshold)
        key = ("streamed", level, threshold)
        if key not in self._dec_cache:

            def body(x, taps):
                def dec1(a):
                    return _level1_dec_sharded(a, taps, self.spec).astype(
                        a.dtype
                    )

                def dec1_full(a):
                    bands = dec1(a)
                    if threshold:
                        bands = shrink_details(bands, threshold)
                    return bands

                def rec1(group):
                    acc = _level1_rec_sharded(group, taps, self.spec)
                    if not self.plan.preserve_l2:
                        acc = acc / (2**self.plan.ndim)
                    return acc.astype(group.dtype)

                return _streamed_pair(
                    x,
                    dec_approx=lambda a: dec1(a)[0],
                    dec_full=dec1_full,
                    rec1=rec1,
                    level=level,
                )

            self._dec_cache[key] = self._jit(body, self.x_spec, self.x_spec)
        return self._dec_cache[key]

    def dec_rec_streamed(self, x, level: int, threshold: float = 0.0):
        return self.dec_rec_streamed_fn(level, threshold)(x)

    def peak_memory_model(self, level: int) -> dict:
        """Per-device peak-memory model (bytes) of the two iterate layouts
        — the feasibility math for BASELINE config #5 (documented with
        worked numbers in DESIGN.md "Config #5 memory layout")."""
        level = int(level)
        nb = 2**self.plan.ndim
        B = num_bands(self.plan.ndim, level)
        local_vox = int(np.prod(self._local_shape))
        item = jnp.dtype(self.plan.real_dtype).itemsize
        # The last axis pass of a level reads the 2^(d-1) half-filtered
        # volumes while it writes the 2^d bands.
        temp = nb // 2
        full = (B + 2 + temp) * local_vox * item
        streamed = (level + 1 + nb + 1 + temp) * local_vox * item
        return {
            "local_voxels": local_vox,
            "full_band_layout_bytes": int(full),
            "streamed_layout_bytes": int(streamed),
            "ratio": full / streamed,
        }

    # ---------------------------------------------------------- split-complex
    # Complex data as a split re/im pair (real filters => the components
    # transform independently; the reference handles complex natively,
    # Functions/nd_dwt_3D.m:150-154). The pair axis leads, unsharded: each
    # device holds both components of its spatial tile, and both ride the
    # SAME shard_map region.

    def _split_specs(self):
        if self.batch_spec:
            raise ValueError(
                "split-complex sharded transforms do not compose with "
                "batch axes; drop batch_spec or transform per item"
            )
        return P(None, *self.spec), P(None, None, *self.spec)

    def dec_split_fn(self, level: int):
        """Jitted sharded split-complex analysis:
        ``(2, *spatial) -> (2, B, *spatial)``, pair and band axes unsharded."""
        level = int(level)
        key = ("split", level)
        if key not in self._dec_cache:
            xs, ys = self._split_specs()
            body = partial(_dec_body, level=level, axis_names=self.spec)
            # _dec_body carries leading batch axes natively:
            # (2, *local) -> (B, 2, *local); pair axis back to front.
            self._dec_cache[key] = self._jit(
                lambda xp, taps: jnp.moveaxis(body(xp, taps), 1, 0), xs, ys
            )
        return self._dec_cache[key]

    def dec_split(self, x_pair, level: int):
        return self.dec_split_fn(level)(x_pair)

    def rec_split_fn(self, level: int):
        """Jitted sharded split-complex synthesis:
        ``(2, B, *spatial) -> (2, *spatial)``."""
        level = int(level)
        key = ("split", level)
        if key not in self._rec_cache:
            xs, ys = self._split_specs()
            body = partial(
                _rec_body, level=level,
                preserve_l2=self.plan.preserve_l2, axis_names=self.spec,
            )
            # _rec_body carries a trailing-of-band batch axis natively:
            # feed (B, 2, *local), get (2, *local).
            self._rec_cache[key] = self._jit(
                lambda yp, taps: body(jnp.moveaxis(yp, 0, 1), taps), ys, xs
            )
        return self._rec_cache[key]

    def rec_split(self, y_pair):
        level = level_from_bands(self.plan.ndim, y_pair.shape[1])
        return self.rec_split_fn(level)(y_pair)

    def dec_rec_split_fn(self, level: int, threshold: float = 0.0):
        """Jitted sharded split-complex iterate: dec both components,
        joint re/im magnitude shrink (the prox of the complex l1 norm —
        the reference's MRI contract, ``Functions/nd_dwt_1D.m:57-61``),
        rec — all in ONE ``shard_map`` region. Returns ``(bands, x_pair)``."""
        level = int(level)
        threshold = float(threshold)
        key = ("splitpair", level, threshold)
        if key not in self._dec_cache:
            xs, ys = self._split_specs()

            def body(xp, taps):
                y = jnp.moveaxis(_dec_body(xp, taps, level, self.spec), 1, 0)
                if threshold:
                    y = soft_threshold_mag_pair(y, threshold)
                xr = _rec_body(
                    jnp.moveaxis(y, 0, 1), taps, level,
                    self.plan.preserve_l2, self.spec,
                )
                return y, xr

            self._dec_cache[key] = self._jit(body, xs, (ys, xs))
        return self._dec_cache[key]

    def dec_rec_split(self, x_pair, level: int, threshold: float = 0.0):
        return self.dec_rec_split_fn(level, threshold)(x_pair)

    def shard_input_split(self, x_pair):
        """Place a (2, *spatial) split pair: pair axis unsharded, spatial
        axes per ``spec``."""
        return jax.device_put(
            x_pair, NamedSharding(self.mesh, P(None, *self.spec))
        )

    # ------------------------------------------------------------- helpers
    def shard_input(self, x):
        return jax.device_put(x, self.x_sharding)

    def num_bands(self, level: int) -> int:
        return num_bands(self.plan.ndim, level)
