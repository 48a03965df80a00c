"""Benchmark timing harness with forced device synchronization.

The analog of the reference's BenchmarkTools methodology
(`/root/reference/benchmarks/benchtests.jl:11-68`). Two rules every helper
here follows:

1. Every timed region ends with a host scalar fetch (a tiny ``jnp.sum``
   pulled to Python), so the time covers the device work and not only its
   dispatch.
2. Chained helpers feed each output into the next call, so every step has a
   real data dependency and nothing can be elided.

Slope timing (:func:`time_slope`) cancels a fixed per-dispatch overhead;
whether that is needed on the GPU, where ``block_until_ready`` wall time
around a jitted call is the plain measure, is not measured yet.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = [
    "time_fn",
    "time_chained",
    "time_looped",
    "time_slope",
    "time_slope_checked",
    "time_interleaved",
    "bandwidth_gbs",
]


def _drain(out):
    """Force true completion: pull one scalar of ``out`` to the host."""
    leaf = jax.tree_util.tree_leaves(out)[0]
    _ = float(jnp.sum(jnp.ravel(leaf)[:1]))


def time_fn(fn: Callable, *args, inner: int = 10, repeats: int = 3, warmup: int = 2):
    """Best average seconds/call of ``fn(*args)`` with queue-drain sync."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _drain(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        _drain(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def time_chained(fn: Callable, x, inner: int = 10, repeats: int = 3):
    """Like :func:`time_fn` but feeds each output back as the next input
    (requires matching in/out structure); defeats dispatch caching."""
    y = fn(x)
    _drain(y)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        y = x
        for _ in range(inner):
            y = fn(y)
        _drain(y)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def _opaque_step(fn):
    """Wrap one loop-body application in ``lax.optimization_barrier`` so XLA
    cannot algebraically collapse the chain: without the barrier a
    fori_loop of ``x + 1`` constant-folds into ``x + k`` (a rate above the
    memory's peak) and chained transposes can cancel pairwise. Pallas kernels are already opaque; this makes jnp-expressed
    workloads honest too."""
    from jax import lax

    def step(v):
        return lax.optimization_barrier(fn(lax.optimization_barrier(v)))

    return step


def time_looped(fn: Callable, x, k: int = 16, repeats: int = 3):
    """Per-application seconds of shape-preserving ``fn`` with ``k``
    data-dependent applications chained INSIDE one jitted program.

    One dispatch runs ``k`` chained steps via ``lax.fori_loop``, which
    amortizes the per-dispatch overhead device-side. Requires ``fn(x)`` to
    have x's shape/dtype.

    NOTE: the flat per-dispatch overhead is still INCLUDED (divided by k);
    prefer :func:`time_slope`, which cancels it."""
    from jax import lax

    step = _opaque_step(fn)

    @jax.jit
    def loop(x):
        return lax.fori_loop(0, k, lambda i, v: step(v), x)

    y = loop(x)  # compile + warm
    _drain(y)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        y = loop(x)
        _drain(y)
        best = min(best, time.perf_counter() - t0)
    return best / k


def time_slope(fn: Callable, x, k1: int = 8, k2: int = 40, repeats: int = 3):
    """True per-application seconds of shape-preserving ``fn`` with the flat
    per-dispatch overhead cancelled exactly: time k1- and k2-step device-side
    loops and return the slope ``(T_k2 - T_k1) / (k2 - k1)``."""
    from jax import lax

    step = _opaque_step(fn)

    def total(k):
        @jax.jit
        def loop(x):
            return lax.fori_loop(0, k, lambda i, v: step(v), x)

        y = loop(x)
        _drain(y)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            y = loop(x)
            _drain(y)
            best = min(best, time.perf_counter() - t0)
        return best

    return (total(k2) - total(k1)) / (k2 - k1)


def time_interleaved(
    fn: Callable,
    arrs,
    k1: int = 32,
    k2: int = 160,
    repeats: int = 3,
):
    """Collapse-proof per-workload seconds via **m interleaved chains**.

    ``arrs`` is a list of m same-shaped arrays; each ``fori_loop``
    iteration advances EVERY chain once, slot-stable
    (``(x0..x_{m-1}) -> (f(x0)..f(x_{m-1}))`` with barriers). Choose m so
    the live set ``2*m*nbytes`` exceeds the device's on-chip cache (50 MB
    L2 on an H100), or chained workloads run cache-resident; ROTATING the
    carry instead makes XLA shuffle-copy it. Returns slope seconds per
    single ``fn`` application. Litmus: ``fn = x + 1`` should measure at a
    copy-class rate, never above the memory's peak."""
    from jax import lax

    m = len(arrs)
    step1 = _opaque_step(fn)

    def step(state):
        return tuple(step1(x) for x in state)

    def total(k):
        @jax.jit
        def loop(state):
            return lax.fori_loop(0, k, lambda i, s: step(s), state)

        y = loop(tuple(arrs))
        _drain(y)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            y = loop(tuple(arrs))
            _drain(y)
            best = min(best, time.perf_counter() - t0)
        return best

    return (total(k2) - total(k1)) / (k2 - k1) / m


def time_slope_checked(
    fn: Callable,
    x,
    k1: int = 8,
    k2: int = 56,
    repeats: int = 3,
    min_delta: float = 5e-4,
    max_retries: int = 1,
):
    """:func:`time_slope` with a validity guard: a slope is only trusted
    when the measured loop-length difference ``T_k2 - T_k1 = slope *
    (k2 - k1)`` clears ``min_delta`` seconds — well above host-clock
    jitter. Non-positive or sub-threshold slopes
    retry with 4x longer loops (amortizing the noise) up to ``max_retries``
    times. Returns ``(seconds_per_step, note)``; ``note`` is ``None`` for a
    clean measurement, otherwise a string explaining why the value is
    suspect (never silently negative)."""
    s = float("nan")
    for _ in range(max_retries + 1):
        s = time_slope(fn, x, k1=k1, k2=k2, repeats=repeats)
        if s > 0 and s * (k2 - k1) >= min_delta:
            return s, None
        k1 *= 4
        k2 *= 4
    if not (s > 0):
        return float("nan"), "invalid: non-positive slope after retries"
    return s, f"below noise threshold even at k2={k2 // 4} - treat as upper bound"


def bandwidth_gbs(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9
