"""Multi-process NDDWT benchmark — BASELINE.md config #5.

Runs the 100-iteration dec/rec loop on a 4D volume sharded over a global
device mesh (spatial axes over the mesh, periodic halos via collective
permute). Launch one process per card (or per host), each with the same
coordinator; on GPUs each process takes its own card
(``multihost.host_gpu_id``):

    python scripts/multihost_bench.py --coordinator localhost:12345 \
        --num-processes 4 --process-id $i \
        --shape 256,256,256,32 --wavelet db4 --level 3 --mesh x=4 --iters 100

Single-process validation (8 virtual CPU devices):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python scripts/multihost_bench.py --cpu --shape 64,32,16,8 \
        --wavelet db2 --level 2 --mesh x=4,y=2 --iters 3

Per-process shard construction uses ``make_array_from_callback`` so no
process ever materializes the global volume (512^3 x 64 f32 = 34 GB).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# Make the package importable no matter where (or with what PYTHONPATH)
# this script is launched — multi-process runs spawn it directly.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--shape", default="512,512,512,64")
    p.add_argument("--wavelet", default="db4")
    p.add_argument("--level", type=int, default=3)
    p.add_argument("--mesh", default="x=2,y=1", help="axis=size pairs, comma-sep")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument(
        "--streamed", action="store_true",
        help="use the level-streamed fused iterate (config-#5 memory "
        "layout: one level's bands live at a time — see DESIGN.md)",
    )
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args()


def main():
    args = parse_args()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import non_decimated_wavelets as nw
    from non_decimated_wavelets.parallel import ShardedNDDWT, multihost
    from non_decimated_wavelets.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    local = None
    if not args.cpu and (args.num_processes or 1) > 1:
        local = [multihost.host_gpu_id(args.process_id)]
    multihost.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_device_ids=local,
    )

    shape = tuple(int(s) for s in args.shape.split(","))
    mesh_axes = {}
    for part in args.mesh.split(","):
        k, v = part.split("=")
        mesh_axes[k.strip()] = int(v)
    mesh = multihost.global_mesh(mesh_axes)
    multihost.assert_mesh_synchronized(mesh)

    # Shard the leading spatial axes over the mesh axes, in order.
    names = list(mesh_axes)
    spec = tuple(names[i] if i < len(names) else None for i in range(len(shape)))
    plan = nw.NDDWT(wavelet=args.wavelet, shape=shape, dtype=jnp.float32)
    sh = ShardedNDDWT(plan, mesh, spec)

    rng = np.random.default_rng(jax.process_index())

    def fill(idx):
        lshape = tuple(
            (sl.stop or shape[d]) - (sl.start or 0) for d, sl in enumerate(idx)
        )
        return rng.standard_normal(lshape).astype(np.float32)

    x = multihost.host_local_array(shape, mesh, P(*spec), fill)

    dec = sh.dec_fn(args.level)
    rec = sh.rec_fn(args.level)
    if args.streamed:
        pair = sh.dec_rec_streamed_fn(args.level)
        mem = sh.peak_memory_model(args.level)
    else:
        pair = lambda v: rec(dec(v))
        mem = None

    import jax.lax as lax

    @jax.jit
    def loop(v):
        def body(c, _):
            return pair(c), None

        out, _ = lax.scan(body, v, None, length=args.iters)
        return out

    jax.block_until_ready(loop(x))  # compile
    t0 = time.perf_counter()
    out = jax.block_until_ready(loop(x))
    dt = (time.perf_counter() - t0) / args.iters
    nvox = int(np.prod(shape))
    n_dev = jax.device_count()
    # Single-pair reconstruction error plus the accumulated error of the
    # whole `iters`-deep identity chain (both computed sharded — no host
    # gather of the global volume).
    err1 = float(jnp.max(jnp.abs(pair(x) - x)))
    err = float(jnp.max(jnp.abs(out - x)))

    if jax.process_index() == 0:
        rec_obj = {
            "metric": f"voxels/sec, {args.level}-level {args.wavelet} "
            f"NDDWT dec+rec, shape {shape}, {n_dev} devices"
            + (" [level-streamed layout]" if args.streamed else ""),
            "seconds_per_pair": dt,
            "voxels_per_sec": nvox / dt,
            "voxels_per_sec_per_device": nvox / dt / n_dev,
            "iters": args.iters,
            "processes": jax.process_count(),
            "devices": n_dev,
            "max_abs_roundtrip_err_1pair": err1,
            "max_abs_roundtrip_err_accumulated": err,
        }
        if mem is not None:
            rec_obj["streamed_peak_model"] = mem
        print(json.dumps(rec_obj), flush=True)


if __name__ == "__main__":
    main()
