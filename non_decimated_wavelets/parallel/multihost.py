"""Multi-host runtime glue.

The reference is strictly single-process (SURVEY §5: no NCCL/MPI/Gloo —
only FFTW threads). Here the scaling story is ``jax.distributed``: one
process per host (or per card), with XLA collectives between the cards of
a host and across hosts. This module packages the
bootstrap, global-mesh construction, per-host data placement, and the
fail-fast mesh-desynchronization check the multi-host benchmark runner
needs (SURVEY §5 "failure detection").

All functions degrade gracefully to single-process operation so the same
driver script runs on one chip, one host, or N hosts.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None,
               initialization_timeout: float | None = None,
               local_device_ids=None) -> None:
    """Initialize the distributed runtime (no-op if single-process).

    With no arguments, relies on the cluster detection of
    ``jax.distributed.initialize`` (managed clusters such as SLURM); a
    plain single-process environment is a no-op. Elsewhere pass
    ``coordinator_address`` (e.g. ``localhost:<port>``), ``num_processes``
    and ``process_id`` explicitly.

    A genuine bootstrap failure (unreachable coordinator, mismatched
    process count, bad process id) PROPAGATES — on a cluster a swallowed
    failure would silently degrade an N-host job to N independent
    single-host jobs.
    Only the benign already-initialized / explicitly-single-process cases
    are no-ops. ``local_device_ids`` restricts this process to those local
    devices (one GPU per process: ``[local_rank]``).
    """
    if num_processes is not None and num_processes <= 1:
        return
    if jax.distributed.is_initialized():
        return
    if (
        coordinator_address is None
        and num_processes is None
        and process_id is None
    ):
        # Auto-detection path: a plain single-process environment is not an
        # error, so tolerate only the "no cluster detected" outcome.
        try:
            jax.distributed.initialize()
        except (RuntimeError, ValueError):
            pass
        return
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["initialization_timeout"] = initialization_timeout
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def host_gpu_id(process_id: int) -> int:
    """The local GPU a process takes when each process drives one card.

    The one GPU its launcher left visible (``CUDA_VISIBLE_DEVICES`` naming a
    single card), else ``process_id`` modulo the host's GPU count. The GPUs
    are counted without starting a JAX backend, which must wait for
    :func:`initialize`.
    """
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        count = len(visible.split(","))
    else:
        count = len(subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.split())
    return process_id % count


def global_mesh(axis_sizes: dict) -> Mesh:
    """Build a mesh over ALL devices (across hosts), axes as given.

    The product of axis sizes must equal ``jax.device_count()`` (global).
    """
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes[n] for n in names)
    total = int(np.prod(sizes))
    if total != jax.device_count():
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {total} devices, global count is "
            f"{jax.device_count()}"
        )
    arr = np.array(jax.devices()).reshape(sizes)
    return Mesh(arr, names)


def host_local_array(global_shape, mesh: Mesh, spec: P, fill_fn):
    """Assemble a globally-sharded array from per-host local data.

    ``fill_fn(local_index_tuple) -> np.ndarray`` produces each local shard
    (so hosts only materialize their own slice — required for arrays that
    don't fit one host, e.g. the 512^3 x 64 multi-host config).
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        tuple(global_shape), sharding, lambda idx: fill_fn(idx)
    )


def assert_mesh_synchronized(mesh: Mesh, tol: float = 0.0) -> None:
    """Fail fast if hosts disagree on mesh content (desynchronized cluster).

    Each device contributes a placement-dependent value — its C-order
    linear mesh index plus ``1000 x`` the owning host's process index —
    psum'd over **every** mesh axis. Every device must observe the expected
    total (computed host-side from the mesh's device array), so a reordered
    mesh, a device attributed to the wrong host, or a desync isolated to a
    non-leading mesh axis all produce a detectable mismatch (a hung device
    stalls the collective). Raises RuntimeError on mismatch.
    """
    import jax.numpy as jnp

    names = mesh.axis_names
    sizes = [mesh.shape[n] for n in names]

    def body():
        lin = jnp.zeros((), jnp.float32)
        mult = 1.0
        for n, sz in zip(reversed(names), reversed(sizes)):
            lin = lin + jnp.float32(jax.lax.axis_index(n)) * mult
            mult *= sz
        # process_index is a per-host trace constant: each host stamps its
        # own devices' contributions.
        contrib = jnp.full((1,), lin + 1000.0 * jax.process_index(), jnp.float32)
        for n in names:
            contrib = jax.lax.psum(contrib, axis_name=n)
        return contrib

    total = jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(), out_specs=P())
    )()
    devs = mesh.devices.ravel()  # C order matches the linear index above
    expect = float(sum(range(devs.size)) + 1000 * sum(d.process_index for d in devs))
    got = float(np.asarray(total)[0])
    if abs(got - expect) > tol:
        raise RuntimeError(
            f"mesh desynchronized: psum observed {got}, expected {expect}"
        )
