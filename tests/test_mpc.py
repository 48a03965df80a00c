"""MPC stack tests: condensed-QP correctness vs a dense numpy oracle, ADMM
constraint satisfaction, closed-loop stabilization of the quadrotor, and
cartpole iLQR cost descent (BASELINE.json configs 3-4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from strided_tpu.models import quadrotor, cartpole, hover_state, hover_input
from strided_tpu.mpc import (
    QuadCost,
    ilqr,
    build_condensed,
    qp_solve,
    qp_solve_unconstrained,
    make_hover_mpc,
    closed_loop,
)


def _quad_qp(N=10, dt=0.05, dtype=jnp.float64):
    m = quadrotor()
    A, B = m.linearize(hover_state(dtype), hover_input(dtype=dtype), dt)
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    return m, A, B, Q, R


def test_condensed_matrices_vs_oracle():
    _, A, B, Q, R = _quad_qp(N=5)
    qp = build_condensed(A, B, Q, R, Q, 5)
    A_, B_ = np.asarray(A, np.float64), np.asarray(B, np.float64)
    n, m = B_.shape
    # oracle: simulate prediction X = Sx x0 + Su U for random x0, U
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(n)
    U = rng.standard_normal((5, m))
    xs = []
    x = x0
    for k in range(5):
        x = A_ @ x + B_ @ U[k]
        xs.append(x)
    X = np.concatenate(xs)
    np.testing.assert_allclose(
        np.asarray(qp.Sx, np.float64) @ x0 + np.asarray(qp.Su, np.float64) @ U.reshape(-1),
        X,
        rtol=1e-10,
    )


def test_unconstrained_qp_minimizes_oracle_cost():
    _, A, B, Q, R = _quad_qp(N=8)
    qp = build_condensed(A, B, Q, R, Q, 8)
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.standard_normal(12) * 0.2)
    U = np.asarray(qp_solve_unconstrained(qp, x0)).reshape(-1)
    H = np.asarray(qp.H, np.float64)
    g = np.asarray(qp.M, np.float64) @ np.asarray(x0, np.float64)
    # optimality: H U + g = 0
    np.testing.assert_allclose(H @ U + g, 0.0, atol=1e-4)


def test_admm_matches_unconstrained_when_bounds_loose():
    _, A, B, Q, R = _quad_qp(N=8)
    qp = build_condensed(A, B, Q, R, Q, 8, rho=10.0)
    rng = np.random.default_rng(2)
    x0 = jnp.asarray(rng.standard_normal(12) * 0.1)
    U_free = qp_solve_unconstrained(qp, x0)
    big = jnp.full((4,), 1e6)
    U_admm = qp_solve(qp, x0, -big, big, iters=60)
    np.testing.assert_allclose(np.asarray(U_admm), np.asarray(U_free), atol=1e-5)


def test_admm_respects_bounds_and_beats_clipping():
    _, A, B, Q, R = _quad_qp(N=8)
    qp = build_condensed(A, B, Q, R, Q, 8, rho=5.0)
    rng = np.random.default_rng(3)
    x0 = jnp.asarray(rng.standard_normal(12) * 0.5)
    lim = jnp.array([2.0, 0.05, 0.05, 0.05])
    U = np.asarray(qp_solve(qp, x0, -lim, lim, iters=100)).reshape(-1)
    lo = np.tile(np.asarray(-lim), 8)
    hi = np.tile(np.asarray(lim), 8)
    assert (U >= lo - 1e-6).all() and (U <= hi + 1e-6).all()
    # objective of ADMM solution <= objective of naive clipped LQR solution
    H = np.asarray(qp.H, np.float64)
    g = np.asarray(qp.M, np.float64) @ np.asarray(x0, np.float64)
    obj = lambda u: 0.5 * u @ H @ u + g @ u
    U_clip = np.clip(np.asarray(qp_solve_unconstrained(qp, x0)).reshape(-1), lo, hi)
    assert obj(U) <= obj(U_clip) + 1e-8


def test_quadrotor_mpc_stabilizes_hover():
    dt = 0.05
    model, A, B, Q, R = _quad_qp(N=15, dt=dt)
    ctrl = make_hover_mpc(
        model, hover_state(jnp.float64), hover_input(dtype=jnp.float64),
        Q, R, Q, horizon=15, dt=dt,
        u_min=jnp.array([-5.0, -0.5, -0.5, -0.5]),
        u_max=jnp.array([10.0, 0.5, 0.5, 0.5]),
        admm_iters=30,
    )
    rng = np.random.default_rng(4)
    x0 = jnp.asarray(
        np.concatenate([rng.uniform(-0.5, 0.5, 3), np.zeros(9)])
    )
    xs, us = closed_loop(ctrl, model, x0, steps=80, dt=dt)
    final = np.asarray(xs[-1])
    assert np.linalg.norm(final[:3]) < 5e-2  # position regulated to origin
    assert np.linalg.norm(final[3:6]) < 5e-2


def test_quadrotor_mpc_batched_matches_single():
    dt = 0.05
    model, A, B, Q, R = _quad_qp(N=10, dt=dt)
    ctrl = make_hover_mpc(
        model, hover_state(jnp.float64), hover_input(dtype=jnp.float64),
        Q, R, Q, horizon=10, dt=dt,
        u_min=jnp.array([-5.0, -0.2, -0.2, -0.2]),
        u_max=jnp.array([10.0, 0.2, 0.2, 0.2]),
    )
    rng = np.random.default_rng(5)
    x0s = jnp.asarray(rng.uniform(-0.3, 0.3, (16, 12)))
    u_b, _ = ctrl.control(x0s)
    u_0, _ = ctrl.control(x0s[0])
    np.testing.assert_allclose(np.asarray(u_b[0]), np.asarray(u_0), rtol=1e-8, atol=1e-10)


def test_cartpole_ilqr_cost_descends():
    model = cartpole()
    dt = 0.05
    T = 60
    cost = QuadCost(
        Q=jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1])),
        R=jnp.eye(1) * 0.01,
        Qf=jnp.diag(jnp.array([10.0, 100.0, 1.0, 1.0])),
        x_goal=jnp.array([0.0, np.pi, 0.0, 0.0]),  # swing up
    )
    x0 = jnp.zeros(4)
    us0 = jnp.zeros((T, 1))
    res = ilqr(model, cost, x0, us0, dt, iters=40)
    trace = np.asarray(res.costs)
    assert res.cost < cost.total(
        jnp.broadcast_to(x0, (T + 1, 4)), us0
    )  # improved over doing nothing
    # monotone non-increasing trace (line search guards descent)
    assert (np.diff(trace) <= 1e-6).all()
    # substantial improvement
    assert trace[-1] < 0.5 * trace[0]


def test_cartpole_ilqr_swingup_reaches_upright():
    model = cartpole()
    dt = 0.04
    T = 100
    cost = QuadCost(
        Q=jnp.diag(jnp.array([0.1, 1.0, 0.1, 0.1])),
        R=jnp.eye(1) * 0.001,
        Qf=jnp.diag(jnp.array([10.0, 500.0, 10.0, 10.0])),
        x_goal=jnp.array([0.0, np.pi, 0.0, 0.0]),
    )
    x0 = jnp.zeros(4)
    rng = np.random.default_rng(6)
    us0 = jnp.asarray(rng.standard_normal((T, 1)) * 0.1)
    res = ilqr(model, cost, x0, us0, dt, iters=60, mu=1e-2)
    th_final = float(res.xs[-1, 1])
    assert abs(th_final - np.pi) < 0.3  # near upright


def test_riccati_first_input_matches_condensed_qp():
    """Two independent solvers of the same finite-horizon LQ problem —
    Riccati recursion vs condensed-QP gain — must produce the same optimal
    first input (cross-oracle, catches errors in either factorization)."""
    from strided_tpu.mpc import lqr_gains, qp_solve_unconstrained, build_condensed

    dt = 0.05
    model, A, B, Q, R = _quad_qp(N=12, dt=dt)
    N = 12
    qp = build_condensed(A, B, Q, R, Q, N)
    Ks, _ = lqr_gains(A, B, Q, R, Q, N)
    rng = np.random.default_rng(11)
    x0 = jnp.asarray(rng.standard_normal(12) * 0.3)
    u_qp = qp_solve_unconstrained(qp, x0)[0]
    u_ric = -(Ks[0] @ x0)
    np.testing.assert_allclose(np.asarray(u_qp), np.asarray(u_ric), rtol=1e-6, atol=1e-9)


def test_riccati_full_horizon_matches_qp_plan():
    from strided_tpu.mpc import lqr_gains, lqr_apply, qp_solve_unconstrained, build_condensed

    dt = 0.05
    model, A, B, Q, R = _quad_qp(N=8, dt=dt)
    N = 8
    qp = build_condensed(A, B, Q, R, Q, N)
    Ks, _ = lqr_gains(A, B, Q, R, Q, N)
    rng = np.random.default_rng(12)
    x0 = jnp.asarray(rng.standard_normal(12) * 0.2)
    U_qp = np.asarray(qp_solve_unconstrained(qp, x0))
    _, us = lqr_apply(Ks, x0, A, B)
    np.testing.assert_allclose(U_qp, np.asarray(us), rtol=1e-5, atol=1e-8)


def test_bench_config_accuracy():
    """Pin the accuracy of the EXACT headline-bench configuration (ADMM-6,
    rho=8, f32, quadrotor N=50) against a converged f64 numpy ADMM oracle
    on the same QP: the solves/s number carries this tolerance statement.
    chip_smoke.py checks the same bounds on the GPU."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    dev_first, dev_plan, uscale = bench.bench_mpc_accuracy(batch=64)
    assert uscale > 1.0  # inputs are O(1)-scale: the bounds below are tight
    assert dev_first < 1e-4, f"first applied input off by {dev_first:.2e}"
    assert dev_plan < 0.15, f"horizon plan off by {dev_plan:.2e}"


def test_admm_coarse_iters_knob():
    """Mixed-precision ADMM schedule (qp_solve coarse_iters): on CPU the
    precision flag is a no-op so coarse must EQUAL the plain config
    bit-for-bit, pinning that the split-scan refactor changes nothing but
    the matmul precision. Kept as an opt-in throughput/accuracy trade
    (its GPU frontier is not measured)."""
    import jax.numpy as jnp
    import numpy as np
    from strided_tpu.models import quadrotor, hover_state, hover_input
    from strided_tpu.mpc import make_hover_mpc

    dtype = jnp.float32
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1

    def make(coarse):
        return make_hover_mpc(
            model, hover_state(dtype), hover_input(dtype=dtype), Q, R, Q,
            horizon=10, dt=0.02,
            u_min=jnp.array([-5.0, -0.5, -0.5, -0.5], dtype),
            u_max=jnp.array([10.0, 0.5, 0.5, 0.5], dtype),
            admm_iters=12, admm_coarse_iters=coarse,
        )

    x = jnp.asarray(
        np.random.default_rng(0).uniform(-0.3, 0.3, (8, 12)), dtype
    )
    u0 = np.asarray(make(0).plan(x))
    u6 = np.asarray(make(6).plan(x))
    np.testing.assert_array_equal(u0, u6)


def test_fused_admm_kernel_matches_scan():
    """The ADMM solve runs as an XLA scan on every platform (a fused Triton
    kernel lost to it on the H100, see PERF.md). Pins the properties the
    fused path used to be checked against: bounds respected, a ragged batch
    gives the same values as the matching rows of a full one, and a coarse
    schedule equals the plain one on CPU (precision flags are no-ops
    there)."""
    import numpy as np
    import jax.numpy as jnp

    from strided_tpu.models import quadrotor, hover_state, hover_input
    from strided_tpu.mpc import make_hover_mpc
    from strided_tpu.mpc.qp import qp_solve

    dtype = jnp.float32
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    u_min = jnp.array([-5.0, -0.5, -0.5, -0.5], dtype)
    u_max = jnp.array([10.0, 0.5, 0.5, 0.5], dtype)
    ctrl = make_hover_mpc(
        model, hover_state(dtype), hover_input(dtype=dtype), Q, R, Q,
        horizon=8, dt=0.02, u_min=u_min, u_max=u_max,
        admm_iters=6, rho=8.0,
    )
    x = jnp.asarray(
        np.random.default_rng(5).uniform(-0.3, 0.3, (32, 12)), dtype
    )
    dx = x - ctrl.x_eq
    lo = jnp.tile(u_min, ctrl.qp.N)
    hi = jnp.tile(u_max, ctrl.qp.N)
    U_s = np.asarray(qp_solve(ctrl.qp, dx, u_min, u_max, iters=6))
    # bounds respected
    assert (U_s.reshape(32, -1) <= np.asarray(hi) + 1e-6).all()
    assert (U_s.reshape(32, -1) >= np.asarray(lo) - 1e-6).all()
    # a ragged batch (not a multiple of 8) gives the same rows
    U_odd = np.asarray(qp_solve(ctrl.qp, dx[:31], u_min, u_max, iters=6))
    np.testing.assert_allclose(U_odd, U_s[:31], rtol=1e-5, atol=1e-5)
    # coarse (mixed-precision) schedules: on CPU the precision flag is a
    # no-op, so values must match
    U_c = np.asarray(
        qp_solve(ctrl.qp, dx, u_min, u_max, iters=6, coarse_iters=2)
    )
    np.testing.assert_allclose(U_c, U_s, rtol=1e-6, atol=1e-6)
