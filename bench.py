"""Benchmark: quadrotor condensed-QP MPC solves/s on the local GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "solves/s", "device": {...}}

The line is GATED: before printing, the script asserts (a) the on-device
accuracy of the exact headline configuration (ADMM-6 at rho=8, f32 at
HIGHEST: first applied input within 1e-4 of a converged f64 oracle AND
horizon plan within 0.15 — the same bounds tests/test_mpc.py pins on CPU)
and (b) that the compiled tile-pair kernel agrees with XLA's fused
expression. A failed gate raises — no JSON.

Diagnostics (symmetrize bandwidth, bf16 matmul rate, batched rollouts,
iLQR/Riccati f32-device vs f64-CPU deviations) go to stderr. A diagnostic
that fails raises as well: the benchmark never reports around an error.
Times are medians of ``block_until_ready`` wall time over 20 calls after
warm-up. Needs a GPU; refuses to run anywhere else.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

# f64 is used ONLY inside scoped `with jax.enable_x64(True)` blocks running
# the CPU-side oracles; the device path stays f32/bf16.


def _steady(fn, *args, n=20):
    """Median seconds of ``fn(*args)`` over ``n`` calls after warm-up."""
    for _ in range(3):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _controller(horizon=50, admm_iters=6, rho=8.0):
    from strided_tpu.models import quadrotor, hover_state, hover_input
    from strided_tpu.mpc import make_hover_mpc

    dtype = jnp.float32
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    u_min = jnp.array([-5.0, -0.5, -0.5, -0.5], dtype)
    u_max = jnp.array([10.0, 0.5, 0.5, 0.5], dtype)
    ctrl = make_hover_mpc(
        model, hover_state(dtype), hover_input(dtype=dtype), Q, R, Q,
        horizon=horizon, dt=0.02, u_min=u_min, u_max=u_max,
        admm_iters=admm_iters, rho=rho,
    )
    return model, ctrl, u_min, u_max


def bench_mpc_solves(batch=16384, horizon=50, admm_iters=6, rho=8.0):
    """Closed-loop MPC step (solve + RK4 plant step) throughput."""
    dt = 0.02
    model, ctrl, _, _ = _controller(horizon, admm_iters, rho)

    @jax.jit
    def step(x):
        u, _ = ctrl.control(x)
        return model.step(x, u, dt)

    x = jnp.asarray(np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12)), jnp.float32)
    sec = _steady(step, x)
    assert np.isfinite(np.asarray(step(x))).all()
    return batch / sec, sec


def bench_symmetrize_bandwidth(n=8192):
    """``(A + A.T)/2`` at ``n``² f32 through three paths, in GB/s of the
    8 bytes/element a symmetrize must move: ``st.symmetrize`` (the tile-pair
    kernel), the flagship lazy expression (pattern dispatch to the same
    kernel), and the generic engine with the pattern dispatch disabled."""
    import strided_tpu as st
    from strided_tpu.config import set_config, get_config

    a = jnp.asarray(np.random.default_rng(1).standard_normal((n, n)), jnp.float32)
    nbytes = a.size * 4 * 2  # one read of A + one write

    def engine(x):
        v = st.strided(x)
        return st.to_array((v + st.transpose(v)) * 0.5)

    sec_k = _steady(st.symmetrize, a)
    sec_e = _steady(jax.jit(engine), a)
    old = get_config()
    try:
        set_config(expr_pattern_dispatch=False)
        sec_g = _steady(jax.jit(engine), a)
    finally:
        set_config(expr_pattern_dispatch=old.expr_pattern_dispatch)
    return nbytes / sec_k / 1e9, nbytes / sec_e / 1e9, nbytes / sec_g / 1e9


def bench_mpc_accuracy(batch=64, horizon=50, admm_iters=6, rho=8.0):
    """Accuracy of the EXACT bench configuration (ADMM-``admm_iters`` at
    ``rho``, f32) against a converged f64 numpy ADMM oracle on the same
    QP — the tolerance attached to the solves/s headline. Pinned by
    ``tests/test_mpc.py::test_bench_config_accuracy``.

    Returns ``(first_input_dev, plan_dev, u_scale)``: worst |u - u*| of the
    first applied input, worst over the whole horizon plan, and the input
    magnitude scale for context."""
    model, ctrl, u_min, u_max = _controller(horizon, admm_iters, rho)
    x = jnp.asarray(np.random.default_rng(0).uniform(-0.3, 0.3, (batch, 12)), jnp.float32)
    U = np.asarray(jax.jit(ctrl.plan)(x), np.float64)  # (batch, N, m)

    # numpy f64 oracle: the same over-relaxed ADMM run to convergence on the
    # same QP data (mpc/qp.py::qp_solve), all in float64
    qp = ctrl.qp
    dx = np.asarray(x, np.float64) - np.asarray(ctrl.x_eq, np.float64)
    H = np.asarray(qp.H, np.float64)
    Mm = np.asarray(qp.M, np.float64)
    K = np.asarray(qp.K_lqr, np.float64)
    alpha = 1.6
    Hinv = np.linalg.inv(H + qp.rho * np.eye(H.shape[0]))
    lo = np.tile(np.asarray(u_min, np.float64), qp.N)
    hi = np.tile(np.asarray(u_max, np.float64), qp.N)
    g = dx @ Mm.T
    z = np.clip(-dx @ K.T, lo, hi)
    y = np.zeros_like(z)
    for _ in range(2000):
        u = (qp.rho * (z - y) - g) @ Hinv
        u_rel = alpha * u + (1 - alpha) * z
        z = np.clip(u_rel + y, lo, hi)
        y = y + u_rel - z
    U_star = z.reshape(batch, qp.N, qp.m)
    dev_first = float(np.max(np.abs(U[:, 0] - U_star[:, 0])))
    dev_plan = float(np.max(np.abs(U - U_star)))
    return dev_first, dev_plan, float(np.max(np.abs(U_star)))


def bench_smoke():
    """The compiled tile-pair kernel against XLA's fused expression, exact,
    through the kernel entry point and the lazy-expression dispatch. Raises
    on mismatch or when the dispatch does not reach the kernel."""
    import strided_tpu as st
    from strided_tpu.core import lazy_expr as le

    b = jnp.asarray(np.random.default_rng(9).standard_normal((4096, 4096)), jnp.float32)
    got = st.symmetrize(b)
    want = jax.jit(lambda b: (b + b.T) * 0.5)(b)
    assert bool(jnp.array_equal(got, want)), "compiled symmetrize kernel mismatch"
    v = st.strided(b)
    le.LAST_EXPR_DISPATCH = ""
    got = ((v + st.transpose(v)) / 2).materialize()
    assert le.LAST_EXPR_DISPATCH == "pair-kernel", le.LAST_EXPR_DISPATCH
    assert bool(jnp.array_equal(got, jax.jit(lambda b: (b + b.T) / 2)(b)))
    return ["symmetrize", "pair-dispatch"]


def bench_ilqr_accuracy(T=40, iters=15):
    """Cartpole iLQR f32 on the default device vs the same sweep in f64 on
    the CPU backend — the control-trajectory tolerance line."""
    from strided_tpu.models import cartpole
    from strided_tpu.mpc import QuadCost, ilqr

    dt = 0.05

    def run(dtype, device=None):
        model = cartpole()
        cost = QuadCost(
            Q=jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1], dtype)),
            R=jnp.eye(1, dtype=dtype) * 0.01,
            Qf=jnp.diag(jnp.array([10.0, 100.0, 1.0, 1.0], dtype)),
            x_goal=jnp.array([0.0, np.pi, 0.0, 0.0], dtype),
        )
        x0 = jnp.zeros(4, dtype)
        us0 = jnp.asarray(
            np.random.default_rng(3).standard_normal((T, 1)) * 0.05, dtype
        )
        fn = lambda x, u: ilqr(model, cost, x, u, dt, iters=iters)
        if device is not None:
            with jax.default_device(device):
                res = jax.jit(fn)(jax.device_put(x0, device), jax.device_put(us0, device))
                return np.asarray(res.us, np.float64), float(res.cost)
        res = jax.jit(fn)(x0, us0)
        return np.asarray(res.us, np.float64), float(res.cost)

    us32, c32 = run(jnp.float32)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        us64, c64 = run(jnp.float64, cpu)
    return float(np.max(np.abs(us32 - us64))), float(np.max(np.abs(us64))), c32, c64


def bench_riccati_accuracy(N=50):
    """Riccati LQR gain f32 on the device vs f64 on the CPU for the
    quadrotor hover system."""
    from strided_tpu.models import quadrotor, hover_state, hover_input
    from strided_tpu.mpc import lqr_gains

    def run(dtype, device=None):
        model = quadrotor()
        A, B = model.linearize(hover_state(dtype), hover_input(dtype=dtype), 0.02)
        Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
        R = jnp.eye(4, dtype=dtype) * 0.1
        fn = lambda a, b: lqr_gains(a, b, Q, R, Q, N)[0]
        if device is not None:
            with jax.default_device(device):
                Ks = jax.jit(fn)(jax.device_put(A, device), jax.device_put(B, device))
        else:
            Ks = jax.jit(fn)(A, B)
        return np.asarray(Ks[0], np.float64)

    K32 = run(jnp.float32)
    with jax.enable_x64(True):
        K64 = run(jnp.float64, jax.devices("cpu")[0])
    return float(np.max(np.abs(K32 - K64))), float(np.max(np.abs(K64)))


def bench_bf16_matmul(d=4096):
    """bf16 d^3 matmul rate in TFLOP/s (no peak is divided by here)."""
    x = jnp.asarray(np.random.default_rng(6).standard_normal((d, d)), jnp.bfloat16)
    f = jax.jit(lambda x: jnp.matmul(x, x, preferred_element_type=jnp.float32))
    return 2 * d**3 / _steady(f, x) / 1e12


def bench_rollouts(batch=4096, T=100):
    """Batched double-pendulum rollouts, dynamics steps per second."""
    from strided_tpu.models import double_pendulum
    from strided_tpu.mpc import rollout_final

    m = double_pendulum()
    rng = np.random.default_rng(2)
    x0 = jnp.asarray(rng.standard_normal((batch, 4)) * 0.1, jnp.float32)
    us = jnp.asarray(rng.standard_normal((batch, T, 2)) * 0.01, jnp.float32)
    f = jax.jit(lambda x0: rollout_final(m, x0, us, 0.01))
    sec = _steady(f, x0)
    return batch * T / sec, sec


def main():
    from strided_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: JAX's default device is {dev.platform!r}, not a GPU")
    enable_compile_cache()

    # ---- GATES (must pass before any headline is printed) ----
    checks = bench_smoke()
    print(f"[bench] smoke: ok ({', '.join(checks)})", file=sys.stderr)
    dev1, devp, uscale = bench_mpc_accuracy()
    print(
        f"[bench] accuracy at the operating point (ADMM-6 rho=8 f32 vs f64 "
        f"converged oracle, input scale {uscale:.2f}): first applied "
        f"input max|du| = {dev1:.1e}; full horizon plan max|dU| = "
        f"{devp:.1e} (gate: first <= 1e-4, plan <= 0.15)",
        file=sys.stderr,
    )
    assert dev1 <= 1e-4, (
        f"ON-DEVICE accuracy gate failed: first applied input off by "
        f"{dev1:.2e} (> 1e-4) — refusing to print a headline number"
    )
    assert devp <= 0.15, f"horizon plan off by {devp:.2e} (> 0.15)"

    # ---- headline ----
    solves, sec = bench_mpc_solves()
    print(
        f"[bench] quadrotor MPC (N=50, ADMM-6 rho=8, batch 16384): "
        f"{solves:,.0f} solves/s ({sec*1e3:.3f} ms/batch)",
        file=sys.stderr,
    )

    # ---- diagnostics ----
    kgbs, egbs, ggbs = bench_symmetrize_bandwidth()
    print(
        f"[bench] symmetrize 8192^2 f32: kernel {kgbs:.1f} GB/s, flagship "
        f"expression via pattern dispatch {egbs:.1f} GB/s, generic engine "
        f"{ggbs:.1f} GB/s (8 bytes/element moved)",
        file=sys.stderr,
    )
    print(f"[bench] bf16 4096^3 matmul: {bench_bf16_matmul():.1f} TFLOP/s",
          file=sys.stderr)
    steps, _ = bench_rollouts()
    print(f"[bench] double-pendulum rollouts: {steps:,.0f} steps/s", file=sys.stderr)
    dev_i, scale_i, c32, c64 = bench_ilqr_accuracy()
    print(
        f"[bench] cartpole iLQR f32-device vs f64-CPU: max|du| = "
        f"{dev_i:.1e} (input scale {scale_i:.2f}; costs {c32:.4f} vs {c64:.4f})",
        file=sys.stderr,
    )
    dev_r, scale_r = bench_riccati_accuracy()
    print(
        f"[bench] Riccati LQR gain f32-device vs f64-CPU: max|dK| = "
        f"{dev_r:.1e} (gain scale {scale_r:.2f})",
        file=sys.stderr,
    )

    print(json.dumps({
        "metric": "quadrotor MPC solves/s (12-state, N=50, condensed QP, ADMM-6 rho=8, batch 16384)",
        "value": round(solves, 1),
        "unit": "solves/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
