"""Smoke run of the NDDWT on an NVIDIA GPU, through the public entry points.

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --four-cards  # four cards: ShardedNDDWT only

Each phase runs the transform at full size, checks its results against the
NumPy oracle (``non_decimated_wavelets/oracle.py``) or against an
independent path, and prints what it found. Any failed check raises, so the
script exits non-zero. It exits non-zero without a result line when JAX
finds no GPU: it never falls back to the CPU. The last line of standard
output is one JSON object naming the device JAX reports.

Inputs are unit-normal, drawn from a fixed seed. Times are ms per call in a
jitted ``lax.scan`` (after ``block_until_ready``), beside the card's name
and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0


def log(*a):
    print(*a, flush=True)


def check(name, value, tol):
    """Print one check and raise if it fails (NaN fails too)."""
    ok = bool(value <= tol)
    log(f"  {'ok  ' if ok else 'FAIL'} {name}: {value:.3e} (limit {tol:.0e})")
    if not ok:
        raise RuntimeError(f"check failed: {name} = {value!r} > {tol!r}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def max_abs(a, b):
    import jax.numpy as jnp

    a = jnp.asarray(a)
    b = jnp.asarray(b)
    return float(jnp.max(jnp.abs(a.astype(b.dtype) - b)))


def max_abs_host(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def compile_seconds(fn, *args):
    """Cold lower+compile time of ``jax.jit(fn)`` at ``args``."""
    import jax

    t0 = time.perf_counter()
    jax.jit(fn).lower(*args).compile()
    return time.perf_counter() - t0


def ms_per_iter(step, x, iters):
    """Steady-state ms per ``step`` inside one jitted scan of ``iters``."""
    import jax

    @jax.jit
    def loop(v):
        return jax.lax.scan(lambda c, _: (step(c), None), v, None,
                            length=iters)[0]

    jax.block_until_ready(loop(x))  # compile + warm up
    t0 = time.perf_counter()
    out = jax.block_until_ready(loop(x))
    return (time.perf_counter() - t0) * 1e3 / iters, out


def unit_normal(shape, dtype=np.float32, seed=SEED):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ------------------------------------------------------------------ phases
def phase_headline(n=256, n_oracle=128, iters=20):
    import jax
    import jax.numpy as jnp

    import non_decimated_wavelets as nw
    from non_decimated_wavelets import oracle

    level, shape = 3, (n,) * 3
    log(f"[1] headline: db4 L{level} {shape} float32")
    plan = nw.NDDWT("db4", shape, dtype=jnp.float32)
    x = jnp.asarray(unit_normal(shape))
    for band_axis in (-1, 0):
        dec = lambda v, a=band_axis: plan.dec(v, level, band_axis=a)
        rec = lambda v, a=band_axis: plan.rec(v, band_axis=a)
        t_dec = compile_seconds(dec, x)
        y = jax.block_until_ready(jax.jit(dec)(x))
        t_rec = compile_seconds(rec, y)
        ms, _ = ms_per_iter(lambda v: rec(dec(v)), x, iters)
        log(f"  band_axis={band_axis}: bands {y.shape} {y.dtype}, first "
            f"compile dec {t_dec:.2f} s + rec {t_rec:.2f} s, "
            f"{ms:.3f} ms/pair ({iters}-iteration scan)")
        check(f"round trip band_axis={band_axis}",
              max_abs(jax.jit(rec)(y), x), 1e-4)
    yb, xr = jax.jit(lambda v: plan.dec_rec(v, level, threshold=0.1))(x)
    if yb.shape != shape + (plan.num_bands(level),):
        raise RuntimeError(f"dec_rec bands have shape {yb.shape}")
    if not bool(jnp.isfinite(xr).all()):
        raise RuntimeError("dec_rec(threshold=0.1) is not finite")
    log(f"  dec_rec(threshold=0.1): bands {yb.shape}, reconstruction finite")

    tight = nw.NDDWT("db4", shape, preserve_l2=True, dtype=jnp.float32)
    yt = tight.dec(x, level, band_axis=0)
    x64 = x.astype(jnp.float64)
    ratio = float(jnp.sum(jnp.square(yt.astype(jnp.float64)))
                  / jnp.sum(jnp.square(x64)))
    check("preserve_l2 energy ratio - 1", abs(ratio - 1.0), 1e-5)
    del yt

    y32 = plan.dec(x, level, band_axis=0)
    ref = nw.NDDWT("db4", shape, dtype=jnp.float64, path="fft")
    check("f32 bands vs f64 fft path", max_abs(y32, ref.dec(x64, level,
                                                            band_axis=0)),
          1e-4)
    del y32

    shape_o = (n_oracle,) * 3
    xo = unit_normal(shape_o, np.float64, seed=SEED + 1)
    small = nw.NDDWT("db4", shape_o, dtype=jnp.float32)
    yo = small.dec(xo.astype(np.float32), level)
    check(f"f32 reference layout vs oracle at {shape_o}",
          max_abs_host(yo, oracle.dec(xo, "db4", level)), 1e-4)


def phase_f64(n=256, n_oracle=128):
    import jax.numpy as jnp

    import non_decimated_wavelets as nw
    from non_decimated_wavelets import oracle

    level, shape = 3, (n,) * 3
    log(f"[2] float64: db4 L{level} {shape}, direct and fft")
    x = jnp.asarray(unit_normal(shape, np.float64))
    shape_o = (n_oracle,) * 3
    xo = unit_normal(shape_o, np.float64, seed=SEED + 1)
    gold = oracle.dec(xo, "db4", level)
    for path in ("direct", "fft"):
        plan = nw.NDDWT("db4", shape, dtype=jnp.float64, path=path)
        y = plan.dec(x, level, band_axis=0)
        if y.dtype != jnp.float64:
            raise RuntimeError(f"f64 {path} bands are {y.dtype}")
        check(f"{path} round trip", max_abs(plan.rec(y, band_axis=0), x),
              1e-12)
        del y
        small = nw.NDDWT("db4", shape_o, dtype=jnp.float64, path=path)
        check(f"{path} vs oracle at {shape_o}",
              max_abs_host(small.dec(xo, level), gold), 1e-12)


def phase_bf16(n=256):
    import jax.numpy as jnp

    import non_decimated_wavelets as nw

    level, shape = 3, (n,) * 3
    log(f"[3] bfloat16: db4 L{level} {shape}")
    plan = nw.NDDWT("db4", shape, dtype=jnp.bfloat16)
    x = jnp.asarray(unit_normal(shape), jnp.bfloat16)
    y = plan.dec(x, level, band_axis=0)
    if y.dtype != jnp.bfloat16:
        raise RuntimeError(f"bf16 plan returned {y.dtype} bands")
    log(f"  bands {y.shape} {y.dtype}")
    check("round trip", max_abs(plan.rec(y, band_axis=0), x.astype(
        jnp.float32)), 5e-2)


def phase_complex(n=128, n_mri=256, iters=20):
    import jax
    import jax.numpy as jnp

    import non_decimated_wavelets as nw
    from non_decimated_wavelets import oracle
    from non_decimated_wavelets.models import fista_cs_mri

    level, shape = 2, (n,) * 3
    log(f"[4] complex64: db2 L{level} {shape}; fista_cs_mri {n_mri}^2")
    xc = (unit_normal(shape, np.float64)
          + 1j * unit_normal(shape, np.float64, seed=SEED + 1))
    gold = oracle.dec(xc, "db2", level)
    for path in ("auto", "fft"):
        plan = nw.NDDWT("db2", shape, dtype=jnp.float32, path=path)
        y = plan.dec(jnp.asarray(xc, jnp.complex64), level)
        if y.dtype != jnp.complex64:
            raise RuntimeError(f"complex {path} bands are {y.dtype}")
        check(f"{path} vs oracle", max_abs_host(y, gold), 1e-4)

    rng = np.random.default_rng(SEED)
    img = unit_normal((n_mri, n_mri))
    mask = (rng.random((n_mri, n_mri)) < 0.4).astype(np.float32)
    mask[0, 0] = 1.0
    b = jnp.asarray(mask * np.fft.fftn(img, norm="ortho"), jnp.complex64)
    plan2 = nw.NDDWT("db2", (n_mri, n_mri), preserve_l2=True,
                     dtype=jnp.float32)
    run = jax.jit(lambda bb, mm: fista_cs_mri(plan2, bb, mm, lam=1e-3,
                                              level=2, iters=iters))
    mj = jnp.asarray(mask)
    jax.block_until_ready(run(b, mj))
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(b, mj))
    ms = (time.perf_counter() - t0) * 1e3 / iters
    if not bool(jnp.isfinite(out).all()):
        raise RuntimeError("fista_cs_mri output is not finite")
    log(f"  fista_cs_mri {n_mri}^2 db2 L2: {iters} iterations, "
        f"{ms:.3f} ms/iteration, output {out.shape} {out.dtype} finite")


def phase_4d_odd(shape4=(128, 128, 128, 32)):
    import jax.numpy as jnp

    import non_decimated_wavelets as nw
    from non_decimated_wavelets import oracle

    log(f"[5] 4D {shape4} and the reference's odd shapes")
    x = jnp.asarray(unit_normal(shape4))
    for wv, level in (("db1", 1), ("db4", 3)):
        plan = nw.NDDWT(wv, shape4, dtype=jnp.float32)
        y = plan.dec(x, level, band_axis=0)
        gb = y.size * y.dtype.itemsize / 1e9
        log(f"  {wv} L{level}: {y.shape[0]} bands, {gb:.1f} GB")
        check(f"4D {wv} L{level} round trip",
              max_abs(plan.rec(y, band_axis=0), x), 1e-4)
        del y
    del x
    for shape, wv, level in (
        ((164, 64, 40), ("db1", "db3", "db9"), 2),
        ((64, 64, 20, 10), "db2", 2),
    ):
        plan = nw.NDDWT(wv, shape, dtype=jnp.float32)
        xo = unit_normal(shape, np.float64)
        y = plan.dec(xo.astype(np.float32), level)
        check(f"{shape} {wv} L{level} ({plan._resolve_path()}) vs oracle",
              max_abs_host(y, oracle.dec(xo, wv, level)), 1e-4)
        check(f"{shape} round trip", max_abs(plan.rec(y), xo), 1e-4)


def phase_loops(n_img=512, n_1d=1024, iters=100):
    import jax
    import jax.numpy as jnp

    import non_decimated_wavelets as nw
    from non_decimated_wavelets.models import fista_inpaint

    log(f"[6] loops: fista_inpaint {n_img}^2 db2 L3, dec_rec_n {n_1d} db4 L3,"
        f" {iters} iterations each")
    rng = np.random.default_rng(SEED)
    img = unit_normal((n_img, n_img))
    mask = (rng.random((n_img, n_img)) < 0.6).astype(np.float32)
    plan = nw.NDDWT("db2", (n_img, n_img), preserve_l2=True,
                    dtype=jnp.float32)
    solve = jax.jit(lambda bb, mm: fista_inpaint(plan, bb, mm, lam=1e-3,
                                                 level=3, iters=iters))
    p1 = nw.NDDWT("db4", (n_1d,), dtype=jnp.float32)
    chain = jax.jit(lambda v: p1.dec_rec_n(v, 3, (1e-3,) * iters))
    for label, fn, args in (
        ("fista_inpaint", solve, (jnp.asarray(mask * img),
                                  jnp.asarray(mask))),
        ("dec_rec_n", chain, (jnp.asarray(unit_normal((n_1d,))),)),
    ):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ms = (time.perf_counter() - t0) * 1e3 / iters
        if not bool(jnp.isfinite(out).all()):
            raise RuntimeError(f"{label} output is not finite")
        log(f"  {label}: {ms:.4f} ms/iteration, output {out.shape} finite")


def phase_four_cards(n=512, iters=20):
    import jax
    import jax.numpy as jnp

    import non_decimated_wavelets as nw
    from non_decimated_wavelets.parallel import ShardedNDDWT, make_mesh

    level, lam, shape = 3, 0.1, (n,) * 3
    devs = jax.devices()[:4]
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    log(f"[4 cards] ShardedNDDWT db4 L{level} {shape} float32 on "
        f"{len(devs)} x {devs[0].device_kind}")
    plan = nw.NDDWT("db4", shape, dtype=jnp.float32)
    x_host = unit_normal(shape)
    results = []
    for axes, spec in (({"x": 4}, ("x", None, None)),
                       ({"x": 2, "y": 2}, ("x", "y", None))):
        sh = ShardedNDDWT(plan, make_mesh(axes, devs), spec)
        xs = sh.shard_input(x_host)
        out = {
            "dec": sh.dec(xs, level),
            "dec_rec": sh.dec_rec(xs, level, threshold=lam),
            "streamed": sh.dec_rec_streamed(xs, level, threshold=lam),
        }
        out["rec"] = sh.rec(out["dec"])
        jax.block_until_ready(out)
        dec_fn, rec_fn = sh.dec_fn(level), sh.rec_fn(level)
        ms, _ = ms_per_iter(lambda v: rec_fn(dec_fn(v)), xs, iters)
        log(f"  mesh {axes}: {ms:.3f} ms/pair ({iters}-iteration scan); "
            f"bands {out['dec'].shape} sharded {out['dec'].sharding.spec}")
        results.append((axes, sh, out))
    log("  device memory after the sharded runs (GB):")
    for d in devs:
        st = d.memory_stats() or {}
        log(f"    {d}: in use {st.get('bytes_in_use', 0) / 1e9:.2f}, "
            f"peak {st.get('peak_bytes_in_use', 0) / 1e9:.2f}, "
            f"limit {st.get('bytes_limit', 0) / 1e9:.2f}")

    x0 = jax.device_put(x_host, devs[0])
    y_ref = plan.dec(x0, level, band_axis=0)
    ms1, _ = ms_per_iter(
        lambda v: plan.rec(plan.dec(v, level, band_axis=0), band_axis=0),
        x0, iters)
    log(f"  unsharded on {devs[0]}: {ms1:.3f} ms/pair ({iters}-iteration "
        "scan)")
    yt_ref, xt_ref = plan.dec_rec(x0, level, threshold=lam, band_axis=0)
    refs = {"dec": y_ref, "rec": plan.rec(y_ref, band_axis=0),
            "dec_rec": (yt_ref, xt_ref), "streamed": xt_ref}
    for axes, sh, out in results:
        for name, got in out.items():
            want = refs[name]
            pairs = (zip(("bands", "recon"), got, want) if name == "dec_rec"
                     else [("", got, want)])
            for part, g, w in pairs:
                w = jax.device_put(w, g.sharding)
                check(f"mesh {axes} {name} {part} vs one card".replace(
                    "  ", " "), max_abs(g, w), 1e-4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card ShardedNDDWT phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev}); "
              "refusing to run on another backend", file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    from non_decimated_wavelets.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    held = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache: {cache} ({held} entries at start)")
    log(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}")
    log(f"card (name, power limit): {card_line()}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_headline()
        phase_f64()
        phase_bf16()
        phase_complex()
        phase_4d_odd()
        phase_loops()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card (name, power limit): {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
