"""Tracing / profiling utilities.

The reference had only ``tic/toc`` wall timing in scripts
(``Test/nddwt1D_test.m:17-22``); here the equivalents are
``jax.profiler`` trace annotations (named scopes appear in the profiler
trace) and a steady-state throughput reporter. The transform
engine's named scopes are emitted from ``plan.NDDWT.dec/rec``.
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


@contextlib.contextmanager
def trace_annotated(name: str):
    """Named trace region: shows up in jax.profiler / xprof timelines."""
    with jax.profiler.TraceAnnotation(name):
        yield


class Timer:
    """Wall-clock timer; :meth:`sync` waits for a result on the device."""

    def __init__(self):
        self.t0 = None
        self.elapsed = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False

    @staticmethod
    def sync(arr):
        return jax.block_until_ready(arr)


def throughput_report(fn, x, iters: int = 10, warmup: int = 1):
    """Steady-state seconds/call and voxels/sec for a jitted transform."""
    out = None
    for _ in range(warmup):
        out = fn(x)
    Timer.sync(out)
    with Timer() as t:
        for _ in range(iters):
            out = fn(x)
        Timer.sync(out)
    per_call = t.elapsed / iters
    nvox = int(np.prod(x.shape))
    return {
        "seconds_per_call": per_call,
        "voxels_per_sec": nvox / per_call,
        "shape": tuple(x.shape),
    }
