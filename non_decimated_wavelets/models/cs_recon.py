"""Compressed-sensing MRI reconstruction with an NDDWT sparsifier.

The reference library was written for exactly this loop — iterative
algorithms applying the same transform hundreds of times (its design
rationale: precomputed filter cache, ``README.md:2``, author affiliation in
``Functions/nd_dwt_1D.m:57-61``). Here is the loop itself: FISTA for

    min_x  0.5 || M ⊙ F x - b ||^2 + lam || W x ||_1

with ``F`` the (orthonormal) FFT, ``M`` a sampling mask, and ``W`` the
non-decimated DWT. ``transform`` may be a single-device ``NDDWT`` plan
(band-last) or a ``ShardedNDDWT`` (band-first, spatial axes sharded over the
mesh) — the same code scales from one card to several.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .denoise import shrink_details


def _dec(transform, x, level):
    from ..parallel.sharded import ShardedNDDWT

    if isinstance(transform, ShardedNDDWT):
        return transform.dec(x, level)
    return transform.dec(x, level, band_axis=0)


def _rec(transform, y):
    from ..parallel.sharded import ShardedNDDWT

    if isinstance(transform, ShardedNDDWT):
        return transform.rec(y)
    return transform.rec(y, band_axis=0)


def _prox(transform, v, lam, level):
    """``W^T soft(W v, lam)`` (details only). A static ``lam`` routes
    through the transform's ``dec_rec`` iterate (one ``shard_map`` region
    for a sharded transform)."""
    from ..parallel.sharded import ShardedNDDWT
    from ..plan import NDDWT

    if not hasattr(lam, "shape"):
        if isinstance(transform, NDDWT):
            _, xr = transform.dec_rec(
                v, level, threshold=float(lam), band_axis=0
            )
            return xr
        if isinstance(transform, ShardedNDDWT):
            _, xr = transform.dec_rec(v, level, threshold=float(lam))
            return xr
    y = _dec(transform, v, level)
    return _rec(transform, shrink_details(y, lam))


def _prox_split(transform, v_pair, lam, level):
    """Split-complex prox: ``W^T shrink_mag(W v, lam)`` with the joint
    re/im magnitude shrink (the prox of the *complex* l1 norm — the
    reference's MRI contract, ``Functions/nd_dwt_1D.m:57-61``). A static
    ``lam`` routes through the ``dec_rec_split`` iterate (one shard_map
    region on the multi-card path); a traced ``lam`` composes the split
    transforms with the shared magnitude shrink."""
    from ..parallel.sharded import ShardedNDDWT
    from ..plan import NDDWT

    if not isinstance(transform, (NDDWT, ShardedNDDWT)):
        raise TypeError(
            f"expected NDDWT or ShardedNDDWT, got {type(transform).__name__}"
        )
    if not hasattr(lam, "shape"):
        _, xr = transform.dec_rec_split(v_pair, level, threshold=float(lam))
        return xr
    # Traced lam: generic composition (works for both transform kinds).
    from .denoise import soft_threshold_mag_pair

    y = transform.dec_split(v_pair, level)  # (2, B, *spatial)
    return transform.rec_split(soft_threshold_mag_pair(y, lam))


def _fwd(x, mask):
    axes = tuple(range(x.ndim))
    return mask * jnp.fft.fftn(x, axes=axes, norm="ortho")


def _adj(k, mask):
    axes = tuple(range(k.ndim))
    return jnp.fft.ifftn(mask * k, axes=axes, norm="ortho")


def ista_step(transform, x, b, mask, lam, step, level):
    """One proximal-gradient step: data-consistency + wavelet shrinkage.

    With ``preserve_l2`` the transform is a tight frame, so
    ``prox_{lam||W.||_1}(v) ≈ W^T soft(W v, lam)`` is the standard
    cycle-spinning surrogate.
    """
    grad = _adj(_fwd(x, mask) - b, mask)
    v = x - step * grad
    return _prox(transform, v, lam * step, level)


def fista_cs_mri(transform, b, mask, lam, level=2, iters=20, step=1.0):
    """FISTA on the masked-Fourier CS problem; returns the reconstruction.

    ``b``: observed k-space (same shape as the image), ``mask``: 0/1
    sampling mask. The loop body is a single jitted program; the transform's
    cached filter bank makes every iteration cheap — the reference's whole
    raison d'être, now fused end-to-end by XLA.
    """
    x = _adj(b, mask)

    def body(carry, _):
        x, z, t = carry
        x_new = ista_step(transform, z, b, mask, lam, step, level)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        z_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        return (x_new, z_new, t_new), None

    (x, _, _), _ = jax.lax.scan(body, (x, x, jnp.asarray(1.0, x.real.dtype)), None, length=iters)
    return x


def fista_inpaint(transform, b, mask, lam, level=2, iters=20, step=1.0):
    """FISTA for image-domain masked observation (inpainting):
    ``min_x 0.5 ||M ⊙ x - b||^2 + lam ||W x||_1``.

    ``b`` may be real or complex; the loop is one ``lax.scan``.
    """
    x = mask * b

    def prox_grad(z):
        grad = mask * (mask * z - b)
        v = z - step * grad
        return _prox(transform, v, lam * step, level)

    def body(carry, _):
        x, z, t = carry
        x_new = prox_grad(z)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        z_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        return (x_new, z_new, t_new), None

    (x, _, _), _ = jax.lax.scan(
        body, (x, x, jnp.asarray(1.0, x.dtype)), None, length=iters
    )
    return x


def fista_inpaint_split(transform, b_pair, mask, lam, level=2, iters=20,
                        step=1.0):
    """FISTA for image-domain masked observation of COMPLEX data carried as
    a split re/im pair: ``min_x 0.5 ||M ⊙ x - b||^2 + lam ||W x||_{1,c}``
    with ``x`` complex, stored as ``(2, *shape)`` real, and ``||.||_{1,c}``
    the complex l1 norm (joint re/im magnitude).

    The filters are real, so the components transform independently,
    matching the reference's native complex handling
    (``Functions/nd_dwt_3D.m:150-154``). ``transform`` may be a
    single-device ``NDDWT`` or a ``ShardedNDDWT``. ``mask`` is real with
    the plan's spatial shape; ``b_pair`` is ``(2, *shape)``.
    """
    x = mask[None] * b_pair

    def prox_grad(z):
        grad = mask[None] * (mask[None] * z - b_pair)
        v = z - step * grad
        return _prox_split(transform, v, lam * step, level)

    def body(carry, _):
        x, z, t = carry
        x_new = prox_grad(z)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        z_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        return (x_new, z_new, t_new), None

    (x, _, _), _ = jax.lax.scan(
        body, (x, x, jnp.asarray(1.0, x.dtype)), None, length=iters
    )
    return x
