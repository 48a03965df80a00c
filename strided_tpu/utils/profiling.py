"""Profiling / tracing helpers — the aux-subsystem analog (SURVEY.md §5).

The reference has no built-in tracing (a commented-out timing probe at
`/root/reference/src/mapreduce.jl:148-149`); profiling is external
BenchmarkTools. The JAX equivalents wired here: the JAX profiler (Perfetto
traces viewable in ui.perfetto.dev / xprof) and named annotation ranges.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import jax

__all__ = ["trace", "annotate", "Timer"]


@contextlib.contextmanager
def trace(logdir: str = "/tmp/strided_tpu_trace") -> Iterator[str]:
    """Capture a device trace for the enclosed block.

    with profiling.trace("/tmp/t") as d:
        run_workload()
    # inspect d with xprof / perfetto
    """
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named range visible in profiler timelines (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


class Timer:
    """Cheap wall-clock scope timer for host-side phases."""

    def __init__(self, name: str, sink=print):
        self.name, self.sink = name, sink

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sink(f"[{self.name}] {time.perf_counter() - self.t0:.4f}s")
        return False
