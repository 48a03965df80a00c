"""Benchmark sweeps — methodology parity with the reference's
`/root/reference/benchmarks/benchtests.jl:9-133` (size sweeps over sum /
permutedims / mul / tensor contraction) plus the README worked examples
(`/root/reference/README.md:56-154`): symmetrize (row 1) and the
compute-bound broadcast (row 3). Each workload is timed through the strided
engine and through plain jnp/XLA as the in-framework baseline, on whatever
backend is active.

Timing: every workload is wrapped shape-preserving (result feeds back into
the input with an epsilon weight so nothing can be dead-code-eliminated) and
measured with ``time_slope_checked`` — k chained applications inside one
jitted ``fori_loop`` at two loop lengths; the slope cancels the fixed
per-dispatch overhead, and sub-noise / non-positive slopes retry with longer
loops and are *flagged in the record itself* (never silently wrong).
No GPU numbers from this script are recorded yet.

Usage:  timeout 590 python benchmarks/sweeps.py [--quick]
Writes `benchmarks/results_<backend>.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import strided_tpu as st
from strided_tpu.utils.timing import time_slope_checked

EPS = 1e-30  # keeps a data dependency without perturbing values


def _record(results, bench, size, f_str, f_jnp, x, extra=None):
    """Time both paths with the checked slope harness and append one fully
    annotated record (notes attached BEFORE serialization)."""
    s_str, note_s = time_slope_checked(f_str, x, k1=32, k2=160)
    s_jnp, note_j = time_slope_checked(f_jnp, x, k1=32, k2=160)
    r = {"bench": bench, "size": size, "strided_s": s_str, "jnp_s": s_jnp}
    notes = [n for n in (note_s and f"strided: {note_s}",
                         note_j and f"jnp: {note_j}") if n]
    if extra:
        for k, per_byte_or_flops in extra.items():
            r[k] = (per_byte_or_flops / s_str / 1e9) if s_str > 0 else float("nan")
        gbs = r.get("strided_gbs")
        if gbs is not None:
            # chained workloads whose working set fits the device's on-chip
            # cache (50 MB L2 on an H100) run cache-resident: their rates
            # are steady-state chained rates, not device-memory bandwidth
            ws_mb = 2 * x.size * x.dtype.itemsize / 1e6
            if ws_mb < 50:
                notes.append(
                    f"cache-resident chained regime (working set "
                    f"{ws_mb:.0f} MB < 50 MB L2): rates are steady-state "
                    f"chained, not memory bandwidth"
                )
    if notes:
        r["note"] = "; ".join(notes)
    results.append(r)
    return r


def bench_sum(results, quick):
    """sum over a lazy transposed view — benchtests.jl's sum family."""
    for d in ([2048, 8192] if quick else [1024, 2048, 4096, 8192]):
        a = jnp.asarray(np.random.default_rng(0).standard_normal((d, d)), jnp.float32)
        f_str = lambda x: x + st.sreduce(lambda v: v, jnp.add, st.transpose(st.strided(x))) * EPS
        f_jnp = lambda x: x + jnp.sum(x.T) * EPS
        # Traffic model: the shape-preserving chain wrapper makes THREE HBM
        # passes per step — read x for the sum, then read x + write x for the
        # chain update (the sum result feeds the update, so the two reads
        # cannot fuse into one pass; the per-step optimization_barrier also
        # forbids cross-step fusion). Charging one pass understates by 3x.
        _record(results, "sum_transposed", d, f_str, f_jnp, a,
                extra={"strided_gbs": 3 * d * d * 4})


def bench_permute(results, quick):
    """4-D reversal permute copy — benchtests.jl's permutedims family."""
    for d in ([32, 64] if quick else [16, 32, 48, 64]):
        a = jnp.asarray(
            np.random.default_rng(1).standard_normal((d, d, d, d)), jnp.float32
        )
        perm = (3, 2, 1, 0)

        def f_str(x):
            out = st.strided(jnp.zeros_like(x))
            return st.permutedims_into(out, st.strided(x), perm).parent.reshape(x.shape)

        f_jnp = lambda x: jnp.transpose(x, perm).copy()
        _record(results, "permutedims_4d", d, f_str, f_jnp, a,
                extra={"strided_gbs": a.size * 4 * 2})


def bench_symmetrize(results, quick):
    """B = (A + A')/2 — the reference's flagship row 1
    (`/root/reference/README.md:69-73`), at its 4000^2 size and 8192^2.
    The strided path is the generic fused engine on the lazy expression;
    `symmetrize_kernel` rows time the dedicated tile-pair Pallas kernel."""
    for d in ([4000] if quick else [4000, 8192]):
        a = jnp.asarray(np.random.default_rng(3).standard_normal((d, d)), jnp.float32)

        def f_str(x):
            v = st.strided(x)
            return st.to_array((v + st.transpose(v)) * 0.5)

        f_jnp = lambda x: (x + x.T) * 0.5
        _record(results, "symmetrize", d, f_str, f_jnp, a,
                extra={"strided_gbs": d * d * 4 * 2})
        # the tile-pair kernel at any size (masked edge tiles)
        f_k = lambda x: st.symmetrize(x, tile=64)
        _record(results, "symmetrize_kernel", d, f_k, f_jnp, a,
                extra={"strided_gbs": d * d * 4 * 2})

        # axpby-transpose spelling (reference README row 2 family /
        # src/linalg.jl:39-42) through the pattern dispatch
        def f_axpby(x):
            v = st.strided(x)
            return st.to_array(3.0 * v + 2.0 * st.transpose(v))

        _record(results, "axpby_transpose", d, f_axpby,
                lambda x: 3.0 * x + 2.0 * x.T, a,
                extra={"strided_gbs": d * d * 4 * 2})

        # the LITERAL linalg spelling axpby!(3, A', 2, A) — routed into the
        # same pair kernel; same-buffer, so one read and one write per
        # element
        def f_axpby_linalg(x):
            v = st.strided(x)
            return st.to_array(st.axpby(3.0, st.transpose(v), 2.0, v))

        _record(results, "axpby_linalg", d, f_axpby_linalg,
                lambda x: 3.0 * x.T + 2.0 * x, a,
                extra={"strided_gbs": d * d * 4 * 2})


def bench_compute_bound(results, quick):
    """B = A.*exp.(-2A) .+ sin.(A.*A) — the reference's compute-bound row 3
    (`/root/reference/README.md:85-89,133-137`): transcendentals dominate,
    so this measures the fused map path's VPU throughput, the regime where
    blocking alone cannot help."""
    for d in ([1024, 4096] if quick else [1000, 2048, 4096, 8192]):
        a = jnp.asarray(np.random.default_rng(4).standard_normal((d, d)), jnp.float32)

        def f_str(x):
            # one fused engine pass: the traced closure is the CaptureArgs
            # analog, exactly how the reference fuses this expression
            return st.to_array(
                st.sbroadcast(
                    lambda t: t * jnp.exp(-2 * t) + jnp.sin(t * t), st.strided(x)
                )
            )

        f_jnp = lambda x: x * jnp.exp(-2 * x) + jnp.sin(x * x)
        _record(results, "compute_broadcast", d, f_str, f_jnp, a,
                extra={"strided_gbs": d * d * 4 * 2})


def bench_mul(results, quick):
    """alpha/beta matmul with a lazy-transposed operand."""
    for d in ([1024, 4096] if quick else [512, 1024, 2048, 4096]):
        a = jnp.asarray(np.random.default_rng(2).standard_normal((d, d)), jnp.float32)

        def f_str(x):
            C = st.strided(jnp.zeros((d, d), jnp.float32))
            return st.to_array(st.mul(C, st.transpose(st.strided(x)), st.strided(x)))

        # same precision policy as the engine (exact-f32 mode) so the
        # comparison is apples-to-apples; the engine's speed/accuracy knob is
        # STRIDED_TPU_MATMUL_PRECISION.
        from jax import lax

        f_jnp = lambda x: jnp.matmul(x.T, x, precision=lax.Precision.HIGHEST)
        _record(results, "mul_At_B", d, f_str, f_jnp, a,
                extra={"strided_tflops": 2 * d**3 / 1e3})


def bench_contraction(results, quick):
    """MERA-style ternary contraction C[a,d] = sum_bc A[a,b,c] W[b,c,d]
    (benchtests.jl's tensor workload family), via lazy sreshape + mul.

    Bond dims 64-192: d=128 is ~8.6 GFLOP/step and d=192 ~43 GFLOP."""
    for d in ([64, 128] if quick else [64, 128, 192]):
        A = jnp.asarray(
            np.random.default_rng(4).standard_normal((d * 4, d, d)), jnp.float32
        )
        W = jnp.asarray(
            np.random.default_rng(5).standard_normal((d, d, d * 4)), jnp.float32
        )

        def f_str(x):
            xv = st.sreshape(st.strided(x), (d * 4, d * d))
            wv = st.sreshape(st.strided(W), (d * d, d * 4))
            C = st.strided(jnp.zeros((d * 4, d * 4), jnp.float32))
            r = st.to_array(st.mul(C, xv, wv))
            return x + r.sum() * EPS

        # equal precision (HIGHEST) on both sides, like bench_mul — a bare
        # einsum may run at DEFAULT (TF32) and would win on precision, not
        # dispatch
        from jax import lax

        f_jnp = lambda x: x + jnp.einsum(
            "abc,bcd->ad", x, W, precision=lax.Precision.HIGHEST
        ).sum() * EPS
        flops = 2 * (d * 4) * (d * 4) * d * d
        _record(results, "contraction_mera", d, f_str, f_jnp, A,
                extra={"strided_tflops": flops / 1e3})


def bench_permute4_sum(results, quick):
    """Reference README row 5 (`/root/reference/README.md:101-105`): the sum
    of four cyclic permutes of A into B, FUSED (lazy views -> one engine
    pass) vs the materialize-temporaries spelling — the reference's 7.8x
    fusion-win story. The temporaries arm forces each permute through an
    ``optimization_barrier`` (the eager-Julia-Base analog: 3 materialized
    32 MiB temporaries); the fused arms read A four ways and write B in one
    pass. Two records per size:

    - ``permute4_fused``:       strided fused expr vs the fused jnp spelling
                                (parity check — XLA fuses too)
    - ``permute4_temporaries``: strided fused expr vs barriered temporaries
                                (the fusion advantage; ratio column = win)

    GB/s model: 5 passes (4 reads + 1 write) for the fused arm."""
    from jax import lax

    p2, p3, p4 = (1, 2, 3, 0), (2, 3, 0, 1), (3, 0, 1, 2)
    for d in ([32, 64] if quick else [32, 48, 64]):
        a = jnp.asarray(
            np.random.default_rng(7).standard_normal((d, d, d, d)), jnp.float32
        )

        def f_str(x):
            v = st.strided(x)
            e = (v + st.permutedims(v, p2) + st.permutedims(v, p3)
                 + st.permutedims(v, p4))
            return st.to_array(e)

        def f_jnp_fused(x):
            return (x + jnp.transpose(x, p2) + jnp.transpose(x, p3)
                    + jnp.transpose(x, p4))

        def f_jnp_temporaries(x):
            t2 = lax.optimization_barrier(jnp.transpose(x, p2))
            t3 = lax.optimization_barrier(jnp.transpose(x, p3))
            t4 = lax.optimization_barrier(jnp.transpose(x, p4))
            return x + t2 + t3 + t4

        _record(results, "permute4_fused", d, f_str, f_jnp_fused, a,
                extra={"strided_gbs": a.size * 4 * 5})
        _record(results, "permute4_temporaries", d, f_str, f_jnp_temporaries,
                a, extra={"strided_gbs": a.size * 4 * 5})


ALL_BENCHES = (
    bench_sum,
    bench_permute,
    bench_symmetrize,
    bench_compute_bound,
    bench_mul,
    bench_contraction,
    bench_permute4_sum,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated bench-fn suffixes, e.g. sum,permute")
    args = ap.parse_args()
    results = []
    benches = ALL_BENCHES
    if args.only:
        keys = args.only.split(",")
        benches = [f for f in ALL_BENCHES if any(k in f.__name__ for k in keys)]
    for fn in benches:
        fn(results, args.quick)
        print(f"[sweeps] {fn.__name__} done", file=sys.stderr, flush=True)
    backend = jax.default_backend()
    out = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), f"results_{backend}.json"
    )
    # Merge with any existing file by (bench, size) so families can be run
    # incrementally (--only sum, then ...).
    merged = {}
    if args.only and os.path.exists(out):
        try:
            with open(out) as f:
                for r in json.load(f).get("results", []):
                    merged[(r["bench"], r["size"])] = r
        except (OSError, ValueError, KeyError):
            merged = {}
    for r in results:
        merged[(r["bench"], r["size"])] = r
    all_results = list(merged.values())
    # Every record is complete (incl. notes) BEFORE serialization.
    with open(out, "w") as f:
        json.dump({"backend": backend, "results": all_results}, f, indent=1)
    for r in results:
        ratio = r["jnp_s"] / r["strided_s"] if r["strided_s"] > 0 else float("nan")
        extra = " [" + r["note"] + "]" if "note" in r else ""
        if "strided_gbs" in r:
            extra += f" {r['strided_gbs']:7.1f} GB/s"
        if "strided_tflops" in r:
            extra += f" {r['strided_tflops']:6.1f} TFLOP/s"
        print(
            f"{r['bench']:18s} size={r['size']:5d} strided={r['strided_s']*1e6:9.1f}us "
            f"jnp={r['jnp_s']*1e6:9.1f}us ratio={ratio:5.2f}x{extra}"
        )


if __name__ == "__main__":
    main()
