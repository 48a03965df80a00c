"""f32-vs-f64 tolerance story (SURVEY.md §7 "hard parts", BASELINE.md
"bit-tolerant control-trajectory match"): the reference's baselines are
Float64 CPU; device work runs f32. These tests pin the contract that the f32
stack reproduces the f64 control trajectories within engineering tolerance
at the same horizon."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from strided_tpu.models import quadrotor, hover_state, hover_input
from strided_tpu.mpc import make_hover_mpc, closed_loop


def _run(dtype, steps=40):
    dt = 0.05
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    ctrl = make_hover_mpc(
        model, hover_state(dtype), hover_input(dtype=dtype), Q, R, Q,
        horizon=12, dt=dt,
        u_min=jnp.array([-5.0, -0.5, -0.5, -0.5], dtype),
        u_max=jnp.array([10.0, 0.5, 0.5, 0.5], dtype),
        admm_iters=30,
    )
    x0 = jnp.asarray(
        np.concatenate([[0.3, -0.2, 0.25], np.zeros(9)]), dtype
    )
    xs, us = closed_loop(ctrl, model, x0, steps=steps, dt=dt)
    return np.asarray(xs, np.float64), np.asarray(us, np.float64)


def test_f32_trajectory_matches_f64_within_tolerance():
    xs64, us64 = _run(jnp.float64)
    xs32, us32 = _run(jnp.float32)
    # position trajectory within mm-scale of the f64 run; controls within 1e-2
    assert np.max(np.abs(xs32[:, :3] - xs64[:, :3])) < 5e-3
    assert np.max(np.abs(us32 - us64)) < 2e-2
    # both runs regulate to hover
    assert np.linalg.norm(xs64[-1, :6]) < 5e-2
    assert np.linalg.norm(xs32[-1, :6]) < 5e-2


def _collect_dots(jaxpr, out=None):
    """Recursively collect every dot_general eqn in a (closed) jaxpr,
    descending into scan/cond/while/pjit sub-jaxprs."""
    out = [] if out is None else out
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            if hasattr(v, "eqns"):  # open jaxpr
                _collect_dots(v, out)
            elif hasattr(v, "jaxpr"):  # ClosedJaxpr
                _collect_dots(v.jaxpr, out)
            elif isinstance(v, (tuple, list)):
                for w in v:
                    if hasattr(w, "jaxpr"):
                        _collect_dots(w.jaxpr, out)
                    elif hasattr(w, "eqns"):
                        _collect_dots(w, out)
    return out


def _assert_all_dots_highest(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    dots = _collect_dots(jaxpr.jaxpr)
    assert dots, "expected at least one dot_general in the trace"
    for eqn in dots:
        prec = eqn.params.get("precision")
        assert prec is not None, (
            f"dot_general with DEFAULT (TF32-on-GPU) precision leaked into "
            f"the solver trace: {eqn}"
        )
        flat = prec if isinstance(prec, tuple) else (prec,)
        assert all(p == jax.lax.Precision.HIGHEST for p in flat), (
            f"dot_general precision {prec} != HIGHEST: {eqn}"
        )


def test_no_default_precision_matmul_in_qp_solve():
    """the ADMM hot path must not contain ANY
    default-precision matmul — on the GPU that means TF32 rounding of g/the
    warm start, which biases every ADMM iterate. Pinned at the trace level
    so the CPU suite catches a
    reintroduced bare ``@``."""
    from strided_tpu.mpc import build_condensed, qp_solve, qp_solve_unconstrained

    dtype = jnp.float32
    model = quadrotor()
    A, B = model.linearize(hover_state(dtype), hover_input(dtype=dtype), 0.02)
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    qp = build_condensed(A, B, Q, R, Q, 10)
    x0 = jnp.zeros((4, 12), dtype)
    lim = jnp.ones((4,), dtype)
    _assert_all_dots_highest(
        lambda x: qp_solve(qp, x, -lim, lim, iters=3), x0
    )
    _assert_all_dots_highest(lambda x: qp_solve_unconstrained(qp, x), x0)


def test_no_default_precision_matmul_in_ilqr_and_riccati():
    """Same contract for the iLQR backward/forward sweeps and the Riccati
    recursion."""
    from strided_tpu.models import cartpole
    from strided_tpu.mpc import QuadCost, ilqr, lqr_gains, lqr_apply

    dtype = jnp.float32
    model = cartpole()
    cost = QuadCost(
        Q=jnp.eye(4, dtype=dtype),
        R=jnp.eye(1, dtype=dtype) * 0.01,
        Qf=jnp.eye(4, dtype=dtype),
        x_goal=jnp.zeros(4, dtype),
    )
    x0 = jnp.zeros(4, dtype)
    us0 = jnp.zeros((5, 1), dtype)
    _assert_all_dots_highest(
        lambda x, u: ilqr(model, cost, x, u, 0.05, iters=2).us, x0, us0
    )

    qmodel = quadrotor()
    A, B = qmodel.linearize(hover_state(dtype), hover_input(dtype=dtype), 0.02)
    Q = jnp.eye(12, dtype=dtype)
    R = jnp.eye(4, dtype=dtype)
    _assert_all_dots_highest(lambda a, b: lqr_gains(a, b, Q, R, Q, 4)[0], A, B)
    Ks, _ = lqr_gains(A, B, Q, R, Q, 4)
    _assert_all_dots_highest(
        lambda k, x: lqr_apply(k, x, A, B)[1], Ks, jnp.zeros(12, dtype)
    )


def test_f32_qp_solution_close_to_f64():
    from strided_tpu.mpc import build_condensed, qp_solve

    dt = 0.05
    model = quadrotor()

    def solve(dtype):
        A, B = model.linearize(hover_state(dtype), hover_input(dtype=dtype), dt)
        Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
        R = jnp.eye(4, dtype=dtype) * 0.1
        qp = build_condensed(A, B, Q, R, Q, 15, rho=5.0)
        x0 = jnp.asarray(np.concatenate([[0.4, -0.3, 0.2], np.zeros(9)]), dtype)
        lim = jnp.asarray([3.0, 0.1, 0.1, 0.1], dtype)
        return np.asarray(qp_solve(qp, x0, -lim, lim, iters=80), np.float64)

    U64 = solve(jnp.float64)
    U32 = solve(jnp.float32)
    assert np.max(np.abs(U32 - U64)) < 5e-3
