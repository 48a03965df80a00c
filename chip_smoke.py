"""Drive the system's main path once on an NVIDIA GPU and check every result.

Usage::

    python chip_smoke.py            # one card: phases 1-5 below
    python chip_smoke.py --mesh4    # four cards: the mesh phase only

Phases (one line each, before the last line):

1. device   — JAX's default device is a GPU; prints its kind and count, the
   compile-cache directory and ``memory_analysis()`` of the MPC step.
2. mpc-acc  — the headline MPC configuration (quadrotor, 12 states, 4
   inputs, horizon 50, condensed QP, ADMM-6 at rho=8, f32 at HIGHEST)
   against a converged f64 numpy ADMM oracle.
3. mpc-loop — 20 closed-loop steps at batch 16384, 131072 and 100000.
4. engine-f32 — the strided engine's flagship workloads at full size:
   ``(A + A.T)/2`` (expression and ``st.symmetrize``), ``3A + 2A.T``,
   ``ssum(A, axis=0)``, ``permutedims`` (4,3,2,1) and ``mul`` with
   alpha/beta, each against a plain reference.
5. engine-f64 — symmetrize and ``permutedims`` in float64.
6. mesh4 (``--mesh4`` only) — the sharded MPC step, scenario consensus,
   k-split matmul and sharded reductions on a 1-D mesh of 4 cards, each
   compared with the same computation on one device.

Each phase line carries its result, tolerance, precision, wall time
(compilation included unless it says "steady") and the card's
``nvidia-smi`` name and power limit. The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase makes the script exit non-zero without that line. It runs
in one process and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 0
HORIZON = 50
DT = 0.02
ADMM_ITERS = 6
RHO = 8.0


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({type(e).__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


class Phases:
    """Runs named phases, prints one line per phase, remembers failures."""

    def __init__(self, card: str):
        self.card = card
        self.failed = []

    def run(self, name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            ok, detail = fn(*args, **kwargs)
        except Exception as e:  # a phase that raises is a failed phase
            ok, detail = False, f"raised {type(e).__name__}: {e}"
        secs = time.perf_counter() - t0
        status = "ok" if ok else "FAIL"
        print(f"[{name}] {status} | {detail} | time={secs:.3f}s | card={self.card}",
              flush=True)
        if not ok:
            self.failed.append(name)


def steady_seconds(fn, *args, n=20):
    """Median wall seconds of ``fn(*args)`` over ``n`` calls after warm-up,
    each ending in ``block_until_ready``."""
    import jax
    import numpy as np

    for _ in range(3):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def make_controller():
    import jax.numpy as jnp

    from strided_tpu.models import quadrotor, hover_state, hover_input
    from strided_tpu.mpc import make_hover_mpc

    dtype = jnp.float32
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    ctrl = make_hover_mpc(
        model, hover_state(dtype), hover_input(dtype=dtype), Q, R, Q,
        horizon=HORIZON, dt=DT,
        u_min=jnp.array([-5.0, -0.5, -0.5, -0.5], dtype),
        u_max=jnp.array([10.0, 0.5, 0.5, 0.5], dtype),
        admm_iters=ADMM_ITERS, rho=RHO,
    )
    return model, ctrl, jnp.diag(Q)


def initial_states(batch, key):
    import jax
    import jax.numpy as jnp

    return jax.random.uniform(key, (batch, 12), jnp.float32, -0.3, 0.3)


# ---- phase 1 -----------------------------------------------------------------


def phase_device(cache_dir):
    import jax

    dev = jax.devices()[0]
    model, ctrl, _ = make_controller()

    def step(x):
        u, _ = ctrl.control(x)
        return model.step(x, u, DT)

    x = initial_states(16384, jax.random.key(SEED))
    mem = jax.jit(step).lower(x).compile().memory_analysis()
    mem_s = (
        f"args={mem.argument_size_in_bytes} out={mem.output_size_in_bytes} "
        f"temp={mem.temp_size_in_bytes} code={mem.generated_code_size_in_bytes}"
        if mem is not None else "memory_analysis=None"
    )
    ok = dev.platform == "gpu"
    return ok, (
        f"platform={dev.platform} kind={dev.device_kind} count={len(jax.devices())} "
        f"jax={jax.__version__} cache={cache_dir} | MPC step @16384 bytes: {mem_s} "
        f"| tol=platform must be gpu | precision=n/a"
    )


# ---- phase 2 -----------------------------------------------------------------


def phase_mpc_accuracy():
    import bench

    dev_first, dev_plan, uscale = bench.bench_mpc_accuracy(
        batch=64, horizon=HORIZON, admm_iters=ADMM_ITERS, rho=RHO
    )
    ok = dev_first <= 1e-4 and dev_plan <= 0.15
    return ok, (
        f"first-input max|du|={dev_first:.3e} plan max|dU|={dev_plan:.3e} "
        f"(input scale {uscale:.3f}, batch 64) | tol=first<=1e-4 plan<=0.15 "
        f"vs f64 numpy ADMM (2000 iters) | precision=f32 HIGHEST (IEEE FP32)"
    )


# ---- phase 3 -----------------------------------------------------------------


def phase_mpc_loop(batches=(16384, 131072, 100000), steps=20):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from strided_tpu.mpc import closed_loop

    model, ctrl, qdiag = make_controller()

    @jax.jit
    def run(x0):
        xs, us = closed_loop(ctrl, model, x0, steps, DT)
        dx = xs - ctrl.x_eq
        cost = jnp.mean(jnp.sum(dx * dx * qdiag, -1), 0)  # (steps+1,)
        finite = jnp.all(jnp.isfinite(xs)) & jnp.all(jnp.isfinite(us))
        return cost, finite, us

    parts, ok = [], True
    for b in batches:
        x0 = initial_states(b, jax.random.key(b))
        cost, finite, us = run(x0)
        cost = np.asarray(cost)
        # The state cost rises for the first steps while the controller
        # builds velocity, then must fall every step to the end.
        tail = cost[5:]
        falls = bool(np.all(np.diff(tail) < 0)) and cost[-1] < cost[0]
        good = bool(finite) and falls and us.shape == (b, steps, 4)
        ok &= good
        sec = steady_seconds(run, x0, n=5)
        parts.append(
            f"B={b}: finite={bool(finite)} cost {cost[0]:.4f}->{cost[-1]:.4f} "
            f"falling over steps 5-{steps}={falls} steady {sec * 1e3:.3f} ms/{steps} steps"
        )
    return ok, (
        "; ".join(parts)
        + " | tol=finite, state cost strictly falling over steps 5-20 and "
        "final < initial | precision=f32 HIGHEST (IEEE FP32), XLA scan ADMM"
    )


# ---- phase 4 -----------------------------------------------------------------


def phase_engine_f32(sym_sizes=(8192, 4000), sum_n=8192, perm_n=96, mul_n=4096):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import strided_tpu as st
    from strided_tpu.config import get_config, set_config
    from strided_tpu.core import lazy_expr as le

    parts, ok = [], True
    key = jax.random.key(SEED)
    xla_half = jax.jit(lambda x: (x + x.T) / 2)
    xla_mul = jax.jit(lambda x: (x + x.T) * 0.5)
    xla_32 = jax.jit(lambda x: 3 * x + 2 * x.T)
    for n in sym_sizes:
        a = jax.random.normal(jax.random.fold_in(key, n), (n, n), jnp.float32)
        v = st.strided(a)
        le.LAST_EXPR_DISPATCH = ""
        expr = ((v + st.transpose(v)) / 2).materialize()
        route = le.LAST_EXPR_DISPATCH
        sym = st.symmetrize(a)
        e1 = bool(jnp.array_equal(expr, xla_half(a)))
        e2 = bool(jnp.array_equal(sym, xla_mul(a)))
        got32 = (3 * v + 2 * st.transpose(v)).materialize()
        bound = 2 * jnp.spacing(3 * jnp.abs(a) + 2 * jnp.abs(a.T))
        within = bool(jnp.all(jnp.abs(got32 - xla_32(a)) <= bound))
        ok &= e1 and e2 and within
        kern = steady_seconds(lambda x: st.symmetrize(x), a)
        xla = steady_seconds(xla_mul, a)
        parts.append(
            f"n={n}: (A+A.T)/2 route={route} exact={e1}, symmetrize exact={e2}, "
            f"3A+2A.T within 2ulp={within}; steady symmetrize {kern * 1e6:.1f} us "
            f"vs XLA {xla * 1e6:.1f} us"
        )
        del a, v, expr, sym, got32, bound

    # leading-axis sum against numpy f64
    a = jax.random.normal(jax.random.fold_in(key, 1), (sum_n, sum_n), jnp.float32)
    got = np.asarray(st.to_array(st.ssum(st.strided(a), axis=0)), np.float64).ravel()
    an = np.asarray(a, np.float64)
    err = np.abs(got - an.sum(0))
    lim = 1e-5 * np.abs(an).sum(0)
    sum_ok = bool(np.all(err <= lim))
    ok &= sum_ok
    t_sum = steady_seconds(jax.jit(lambda x: st.to_array(st.ssum(st.strided(x), axis=0))), a)
    parts.append(
        f"ssum axis0 {sum_n}^2 max err/limit={float(np.max(err / lim)):.3e} ok={sum_ok}, "
        f"XLA steady {t_sum * 1e6:.1f} us"
    )
    del a, an

    # permutedims (4,3,2,1) at 96^4 (~340 MB)
    t = jax.random.normal(jax.random.fold_in(key, 2), (perm_n,) * 4, jnp.float32)
    perm = jax.jit(lambda x: st.materialize(st.permutedims(st.strided(x), (3, 2, 1, 0))))
    p = perm(t)
    perm_ok = bool(np.array_equal(np.asarray(p), np.transpose(np.asarray(t), (3, 2, 1, 0))))
    ok &= perm_ok
    t_perm = steady_seconds(perm, t)
    parts.append(
        f"permutedims(4,3,2,1) {perm_n}^4 exact={perm_ok}, XLA steady {t_perm * 1e6:.1f} us"
    )
    del t, p

    # mul(C, A, B, alpha, beta) at 4096^2 vs numpy f64
    n = mul_n
    A = jax.random.normal(jax.random.fold_in(key, 3), (n, n), jnp.float32)
    B = jax.random.normal(jax.random.fold_in(key, 4), (n, n), jnp.float32)
    C = jax.random.normal(jax.random.fold_in(key, 5), (n, n), jnp.float32)
    alpha, beta = 1.5, -0.5
    want = alpha * (np.asarray(A, np.float64) @ np.asarray(B, np.float64)) \
        + beta * np.asarray(C, np.float64)

    def rel_err(precision):
        old = get_config().matmul_precision
        set_config(matmul_precision=precision)
        try:
            got = st.to_array(st.mul(st.strided(C), st.strided(A), st.strided(B), alpha, beta))
        finally:
            set_config(matmul_precision=old)
        got = np.asarray(got, np.float64)
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    e_hi = rel_err("highest")
    e_def = rel_err("default")
    mul_ok = e_hi <= 1e-5
    ok &= mul_ok
    parts.append(
        f"mul {n}^2 alpha=1.5 beta=-0.5 rel Frobenius err HIGHEST={e_hi:.3e} "
        f"(DEFAULT/TF32 {e_def:.3e})"
    )
    return ok, (
        "; ".join(parts)
        + " | tol=symmetrize/(A+A.T)/2 bit-exact vs jitted XLA, 3A+2A.T <= 2 ulp "
        "of |3A|+|2A.T|, ssum |err| <= 1e-5*sum|a| per column, permute exact, "
        "mul rel <= 1e-5 at HIGHEST | precision=f32 (mul at HIGHEST = IEEE FP32)"
    )


# ---- phase 5 -----------------------------------------------------------------


def phase_engine_f64(sym_n=4000, perm_n=32):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import strided_tpu as st

    with jax.enable_x64(True):
        rng = np.random.default_rng(SEED)
        a = rng.standard_normal((sym_n, sym_n))
        v = st.strided(jnp.asarray(a))
        got = np.asarray(((v + st.transpose(v)) / 2).materialize())
        sym_ok = bool(np.array_equal(got, (a + a.T) / 2)) and got.dtype == np.float64
        t = rng.standard_normal((perm_n,) * 4)
        p = np.asarray(st.materialize(st.permutedims(st.strided(jnp.asarray(t)), (3, 2, 1, 0))))
        perm_ok = bool(np.array_equal(p, np.transpose(t, (3, 2, 1, 0))))
        sym = jax.jit(lambda x: st.to_array((st.strided(x) + st.transpose(st.strided(x))) / 2))
        perm = jax.jit(lambda x: st.materialize(st.permutedims(st.strided(x), (3, 2, 1, 0))))
        t_sym = steady_seconds(sym, jnp.asarray(a))
        t_perm = steady_seconds(perm, jnp.asarray(t))
    return sym_ok and perm_ok, (
        f"(A+A.T)/2 {sym_n}^2 exact={sym_ok} steady {t_sym * 1e6:.1f} us; "
        f"permutedims(4,3,2,1) {perm_n}^4 exact={perm_ok} steady {t_perm * 1e6:.1f} us "
        f"| tol=exact vs numpy f64 | precision=f64"
    )


# ---- phase 6 (--mesh4) -------------------------------------------------------


def phase_mesh4(per_device=16384, mm=(1024, 4096, 1024), red=(8192, 2048)):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import strided_tpu as st
    from strided_tpu.parallel import (
        data_sharding, make_mesh, matmul_ksplit, scenario_consensus_control,
        sharded_mpc_step, sharded_reduce,
    )

    devices = jax.devices()[:4]
    if len(devices) < 4:
        return False, f"needs 4 devices, found {len(jax.devices())}"
    mesh = make_mesh(devices=devices)
    model, ctrl, _ = make_controller()
    B = 4 * per_device
    x = initial_states(B, jax.random.key(SEED + 4))
    xs = jax.device_put(x, data_sharding(mesh, 2))

    def spans(*arrs):
        return all(len(a.sharding.device_set) == 4 for a in arrs)

    xn, u = jax.jit(sharded_mpc_step(ctrl, model, mesh, DT))(xs)
    u_cons, plans = jax.jit(scenario_consensus_control(ctrl, mesh))(xs)

    def local_step(x):
        u, U = ctrl.control(x)
        return model.step(x, u, DT), u, U

    x1 = jax.device_put(x, devices[0])
    xn1, u1, U1 = jax.jit(local_step)(x1)
    d_step = max(float(jnp.max(jnp.abs(jax.device_get(xn) - jax.device_get(xn1)))),
                 float(jnp.max(jnp.abs(jax.device_get(u) - jax.device_get(u1)))))
    d_plan = float(np.max(np.abs(np.asarray(plans) - np.asarray(U1))))
    # consensus: the mesh's f32 pmean of per-device means against the f64
    # mean of the single-device inputs; f32 summation over 4 x per_device
    # terms allows a relative 1e-5 of the input scale
    u1n = np.asarray(u1, np.float64)
    u_scale = float(np.max(np.abs(u1n)))
    d_cons = float(np.max(np.abs(np.asarray(u_cons, np.float64) - u1n.mean(0))))
    # Sharded and single-device runs multiply different batch shapes, so
    # the f32 GEMMs may round differently; ADMM carries that into the plan.
    # Both must sit within the accuracy gate's own 1e-4 of each other.
    mpc_ok = d_step <= 1e-4 and d_plan <= 1e-4 and d_cons <= 1e-5 * max(1.0, u_scale)
    span_ok = spans(xn, u, plans, u_cons)

    rng = np.random.default_rng(SEED)
    A = jnp.asarray(rng.standard_normal(mm[:2]), jnp.float32)
    Bm = jnp.asarray(rng.standard_normal(mm[1:]), jnp.float32)
    with jax.default_matmul_precision("highest"):
        C = jax.jit(lambda p, q: matmul_ksplit(p, q, mesh, precision=jax.lax.Precision.HIGHEST))(A, Bm)
        C1 = jax.jit(lambda p, q: p @ q)(jax.device_put(A, devices[0]), jax.device_put(Bm, devices[0]))
    d_mm = float(np.max(np.abs(np.asarray(C) - np.asarray(C1))) / np.max(np.abs(np.asarray(C1))))

    R = jnp.asarray(rng.standard_normal(red), jnp.float32)

    @jax.jit
    def reds(r):
        part = sharded_reduce(lambda z: z, jnp.add, st.strided(r), mesh, axes=1)
        tot = sharded_reduce(jnp.abs, jnp.maximum, st.strided(r), mesh)
        return part.parent, tot

    part, tot = reds(R)
    Rn = np.asarray(R, np.float64)
    d_part = float(np.max(np.abs(np.asarray(part, np.float64) - Rn.sum(1))))
    tot_ok = float(tot) == float(np.abs(np.asarray(R)).max())
    red_ok = d_part <= 1e-3 and tot_ok and d_mm <= 1e-5
    span_ok &= spans(C, part, tot)
    ok = mpc_ok and red_ok and span_ok
    return ok, (
        f"mesh={dict(mesh.shape)} scenarios={B}: step max|d|={d_step:.3e}, "
        f"plans max|d|={d_plan:.3e}, consensus max|d|={d_cons:.3e} (input scale "
        f"{u_scale:.3f}) vs one device; "
        f"ksplit {mm[0]}x{mm[1]}x{mm[2]} rel max|d|={d_mm:.3e}; partial sum max|d|={d_part:.3e}, "
        f"complete max-abs exact={tot_ok}; every output spans 4 devices={span_ok} "
        f"| tol=MPC step/plan 1e-4 abs, consensus 1e-5 x input scale vs f64 mean, "
        f"ksplit 1e-5 rel, partial sum 1e-3 abs ({red[1]} f32 "
        f"terms), "
        f"max exact | precision=f32 HIGHEST (IEEE FP32)"
    )


# ---- main --------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mesh4", action="store_true",
                        help="run only the four-card mesh phase")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's default device is {dev.platform!r}, not a GPU; "
              "refusing to run", file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from strided_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    card = card_name_and_limit()
    phases = Phases(card)
    if args.mesh4:
        phases.run("mesh4", phase_mesh4)
    else:
        phases.run("device", phase_device, cache_dir)
        phases.run("mpc-acc", phase_mpc_accuracy)
        phases.run("mpc-loop", phase_mpc_loop)
        phases.run("engine-f32", phase_engine_f32)
        phases.run("engine-f64", phase_engine_f64)
    print(f"card: {card}", flush=True)
    if phases.failed:
        print(f"chip_smoke: failed phases: {phases.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
