"""Per-level device time of the NDDWT against its byte roofline.

Traces, with ``jax.profiler``, five jitted programs on the GPU: a one-level
``dec`` and ``rec`` and a three-level ``dec`` and ``rec`` of a 256^3 db4
float32 volume (band-first layout), and a 1 GiB elementwise ``v*2+1`` as
the practical bandwidth ceiling, each called back to back. Every time is
device time: the sum of the kernels each program launches, grouped by the
program's HLO module name, all from the same trace.

Every level of the cascade filters the full-resolution approximation, so
one level of analysis is the one-level ``dec`` (read 1 volume, write
``2^d`` bands) and one level of synthesis is the one-level ``rec`` (read
``2^d``, write 1). Its roofline share is that least traffic at the card's
peak bandwidth over the measured time. Each kernel is also listed by its
HLO op, with the shapes it writes and reads in the optimized HLO (its
operand and output bytes, each counted once), so the time of every fusion
can be told apart.

    python scripts/trace_levels.py --out chiprun_out/trace_levels

Needs a GPU; writes ``levels.json``, ``lines.txt`` (the trace's lines, for
reading by hand), the optimized HLO of each program and the raw trace
under ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Peak device-memory bandwidth by ``device_kind`` (NVIDIA data sheet, SXM).
PEAK_BYTES_PER_S = {"NVIDIA H200": 4.8e12}

SHAPE, WAVELET, LEVEL, DTYPE = (256, 256, 256), "db4", 3, "float32"
CALLS = 5
COPY_ELEMS = 256 * 1024 * 1024  # float32: 1 GiB

_ITEMSIZE = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
             "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
             "f64": 8, "c64": 8, "c128": 16}
_SHAPE = re.compile(r"\b(" + "|".join(_ITEMSIZE) + r")\[([\d,]*)\]")
_DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = (.*?) ([a-z][\w\-]*)\((.*)$")


def _shape_bytes(text: str) -> int:
    return sum(_ITEMSIZE[t] * int(np.prod([int(d) for d in dims.split(",")
                                           if d], dtype=np.int64))
               for t, dims in _SHAPE.findall(text))


def hlo_ops(hlo_text: str) -> dict:
    """``{op name: {"op", "out", "out_bytes", "in_bytes"}}`` for every
    instruction of an optimized HLO module; ``in_bytes`` sums the outputs of
    the distinct operands."""
    defs = {}
    for line in hlo_text.splitlines():
        m = _DEF.match(line)
        if m:
            name, out, op, rest = m.groups()
            args = re.split(r"\),\s*[a-z_]+=", rest, maxsplit=1)[0]
            defs[name] = {"op": op, "out": " ".join(s for s in out.split()
                                                     if "[" in s),
                          "out_bytes": _shape_bytes(out),
                          "operands": sorted(set(re.findall(r"%([\w.\-]+)",
                                                            args)))}
    for d in defs.values():
        d["in_bytes"] = sum(defs[o]["out_bytes"] for o in d.pop("operands")
                            if o in defs)
    return defs


def device_events(xplane_path: str, plane_prefix: str = "/device:GPU:0",
                  dump=None):
    """``(stats, start_ns, duration_ns)`` of the kernels on the device.

    A GPU plane may repeat each kernel on summary lines ("XLA Ops", "XLA
    Modules"); only the per-stream lines ("Stream #...") are kept when the
    plane has any. ``dump`` (a file) receives every line's name, event count
    and first events."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    out = []
    for plane in pd.planes:
        if dump is not None:
            dump.write(f"PLANE {plane.name}\n")
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in lines:
            events = list(line.events)
            if dump is not None:
                dump.write(f"  LINE {line.name}: {len(events)} events\n")
                for ev in events[:8]:
                    dump.write(f"    {ev.name} {ev.duration_ns} "
                               f"{dict(ev.stats)}\n")
            if streams and line not in streams:
                continue
            for ev in events:
                out.append((dict(ev.stats), ev.start_ns, ev.duration_ns))
    return out


def reduce_events(events, calls: int):
    """Per HLO module, device ns per call of each HLO op with its launches
    per call; and the busy share of the traced window."""
    per = collections.defaultdict(lambda: collections.defaultdict(
        lambda: [0.0, 0]))
    spans = []
    for stats, start, dur in events:
        spans.append((start, start + dur))
        acc = per[stats.get("hlo_module", "?")][stats.get("hlo_op", "?")]
        acc[0] += dur
        acc[1] += 1
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in spans) - min(s for s, _ in spans)
              if spans else 0)
    ops = {mod: {op: (ns / calls, n / calls) for op, (ns, n) in parts.items()}
           for mod, parts in per.items()}
    return ops, (busy / window if window else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/trace_levels")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"trace_levels: needs a GPU, found {dev}")
    if dev.device_kind not in PEAK_BYTES_PER_S:
        sys.exit(f"trace_levels: no peak bandwidth for {dev.device_kind!r}")
    peak = PEAK_BYTES_PER_S[dev.device_kind]
    from non_decimated_wavelets import NDDWT
    from non_decimated_wavelets.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    plan = NDDWT(WAVELET, SHAPE, dtype=DTYPE)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(SHAPE), DTYPE)

    # Distinct function names give distinct HLO module names in the trace.
    def nddwt_dec_1(v):
        return plan.dec(v, 1, band_axis=0)

    def nddwt_rec_1(v):
        return plan.rec(v, band_axis=0)

    def nddwt_dec_n(v):
        return plan.dec(v, LEVEL, band_axis=0)

    def nddwt_rec_n(v):
        return plan.rec(v, band_axis=0)

    def copy_ceiling(v):
        return v * 2.0 + 1.0

    dec1, rec1, decn, recn, copy = (jax.jit(f) for f in (
        nddwt_dec_1, nddwt_rec_1, nddwt_dec_n, nddwt_rec_n, copy_ceiling))
    big = jnp.ones((COPY_ELEMS,), jnp.float32)
    y1 = jax.block_until_ready(dec1(x))
    yn = jax.block_until_ready(decn(x))
    jax.block_until_ready((rec1(y1), recn(yn), copy(big)))
    programs = (("nddwt_dec_1", dec1, x), ("nddwt_rec_1", rec1, y1),
                ("nddwt_dec_n", decn, x), ("nddwt_rec_n", recn, yn),
                ("copy_ceiling", copy, big))
    os.makedirs(args.out, exist_ok=True)
    compiled = {name: fn.lower(arg).compile() for name, fn, arg in programs}
    ops = {}
    for name, c in compiled.items():
        text = c.as_text()
        with open(os.path.join(args.out, f"{name}.hlo.txt"), "w") as f:
            f.write(text)
        ops[name] = hlo_ops(text)

    with jax.profiler.trace(args.out):
        outs = []
        for _ in range(CALLS):
            outs += [dec1(x), rec1(y1), decn(x), recn(yn), copy(big)]
        jax.block_until_ready(outs)
    del outs

    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    with open(os.path.join(args.out, "lines.txt"), "w") as dump:
        events = device_events(path, dump=dump)
    per_module, busy = reduce_events(events, CALLS)

    def kernels(name):
        """The program's kernels by HLO op, longest first."""
        rows = []
        for op, (ns, launches) in per_module.get(f"jit_{name}", {}).items():
            hlo = ops[name].get(op, {})
            moved = hlo.get("out_bytes", 0) + hlo.get("in_bytes", 0)
            rows.append({"hlo_op": op, "ms": ns / 1e6, "launches": launches,
                         "kind": hlo.get("op"), "out": hlo.get("out"),
                         "operand_and_output_GB": moved / 1e9,
                         "GB_per_s": moved / ns if ns else None})
        return sorted(rows, key=lambda r: -r["ms"])

    copy_ms = sum(r["ms"] for r in kernels("copy_ceiling"))
    copy_bytes = 2 * big.nbytes
    vol = x.size * x.dtype.itemsize
    level_bytes = (1 + 2 ** len(SHAPE)) * vol
    rows = []
    for span, name, n_levels in (
        ("dec level", "nddwt_dec_1", 1), ("rec level", "nddwt_rec_1", 1),
        (f"dec L{LEVEL}", "nddwt_dec_n", LEVEL),
        (f"rec L{LEVEL}", "nddwt_rec_n", LEVEL),
    ):
        ks = kernels(name)
        ms = sum(k["ms"] for k in ks)
        nbytes = n_levels * level_bytes
        rows.append({
            "span": span, "ms": ms, "min_bytes": nbytes,
            "achieved_GB_per_s": nbytes / (ms * 1e-3) / 1e9,
            "roofline_share": nbytes / peak / (ms * 1e-3),
            "copy_share": nbytes / (ms * 1e-3) / (copy_bytes /
                                                  (copy_ms * 1e-3)),
            "xla_bytes": compiled[name].cost_analysis().get("bytes accessed"),
            "kernels": ks,
        })
    report = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "config": {"shape": SHAPE, "wavelet": WAVELET, "level": LEVEL,
                   "dtype": DTYPE, "calls": CALLS},
        "peak_bytes_per_s": peak,
        "copy": {"ms": copy_ms, "bytes": copy_bytes,
                 "GB_per_s": copy_bytes / (copy_ms * 1e-3) / 1e9},
        "rows": rows,
        "busy_share": busy,
    }
    with open(os.path.join(args.out, "levels.json"), "w") as f:
        json.dump(report, f, indent=1)
    for r in rows:
        print(f"{r['span']:>10}: {r['ms']:.4f} ms, least traffic "
              f"{r['min_bytes'] / 1e9:.3f} GB -> "
              f"{r['achieved_GB_per_s']:.1f} GB/s, "
              f"{100 * r['roofline_share']:.2f}% of peak, "
              f"{100 * r['copy_share']:.2f}% of the copy; "
              f"XLA counts {r['xla_bytes'] / 1e9:.3f} GB")
        for k in r["kernels"]:
            print(f"    {k['hlo_op']:<34} {k['ms']:.4f} ms x{k['launches']:g}"
                  f"  {k['kind']} -> {k['out']}; operands+output "
                  f"{k['operand_and_output_GB']:.3f} GB"
                  + (f" = {k['GB_per_s']:.0f} GB/s" if k["GB_per_s"] else ""))
    c = report["copy"]
    print(f"copy: {c['ms']:.4f} ms device time for {c['bytes'] / 1e9:.3f} GB"
          f" -> {c['GB_per_s']:.1f} GB/s "
          f"({100 * c['GB_per_s'] * 1e9 / peak:.2f}% of peak); "
          f"busy share {busy}")


if __name__ == "__main__":
    main()
