"""Throughput timing helpers (the reference's only perf tool is GNU
``time --verbose`` wrappers in its Makefile:30-42; here we time device
compute directly and report GB/s)."""

from __future__ import annotations

import time
from typing import Callable

import jax


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def measure_gbps(fn: Callable, nbytes: int, iters: int = 5, warmup: int = 2) -> dict:
    """Time ``fn()`` (which must return JAX arrays or pytrees thereof)
    and report throughput over ``nbytes`` of input per call."""
    for _ in range(warmup):
        out = fn()
        jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    best = min(times)
    avg = sum(times) / len(times)
    return {
        "best_s": best,
        "avg_s": avg,
        "gbps_best": nbytes / best / 1e9,
        "gbps_avg": nbytes / avg / 1e9,
        "nbytes": nbytes,
    }


def profile_trace(logdir: str):
    """jax.profiler trace context: device timelines for the kernels
    land in ``logdir`` (view with tensorboard/xprof).  The reference's
    only profiling tool is GNU time (Makefile:30-42)."""
    import jax.profiler

    return jax.profiler.trace(logdir)
