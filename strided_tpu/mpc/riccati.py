"""Finite-horizon Riccati recursion — the blocked backward sweep as `scan`.

The north-star's "condensed-QP / Riccati backward sweep runs as blocked
reductions" (BASELINE.json): this module is the Riccati half, a
time-reversed ``lax.scan`` of dense matmuls. It provides both the
time-varying LQR gains and the infinite-horizon (converged) gain, and serves
as an independent oracle for the condensed-QP solver (same optimal control,
two different factorizations — cross-checked in tests)."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import matmul_precision_scope

__all__ = ["lqr_gains", "lqr_apply", "riccati_converge"]


@matmul_precision_scope
def lqr_gains(A, B, Q, R, QN, N: int):
    """Time-varying finite-horizon LQR gains K_t (t = 0..N-1) for
    x_{t+1} = A x_t + B u_t, cost sum x'Qx + u'Ru + terminal x'QN x.

    Returns (Ks, Ps): Ks (N, m, n) with u_t = -K_t x_t; Ps (N+1, n, n)
    cost-to-go matrices (P_N first in recursion order, returned time-major).
    """

    def body(P, _):
        # standard discrete Riccati step — all dense matmuls
        BtP = B.T @ P
        S = R + BtP @ B
        K = jnp.linalg.solve(S, BtP @ A)
        P_new = Q + A.T @ P @ (A - B @ K)
        P_new = 0.5 * (P_new + P_new.T)
        return P_new, (K, P_new)

    P0, (Ks, Ps) = lax.scan(body, QN, None, length=N)
    # scan produced gains for t = N-1 down to 0; flip to time-major
    Ks = jnp.flip(Ks, axis=0)
    Ps = jnp.concatenate([jnp.flip(Ps, axis=0), QN[None]], axis=0)
    return Ks, Ps


@matmul_precision_scope
def lqr_apply(Ks, x0, A, B):
    """Roll the time-varying LQR policy forward; returns (xs, us)."""

    def body(x, K):
        u = -(K @ x)
        return A @ x + B @ u, (x, u)

    _, (xs, us) = lax.scan(body, x0, Ks)
    return xs, us


def riccati_converge(A, B, Q, R, iters: int = 200):
    """Infinite-horizon gain by iterating the Riccati map to fixpoint."""
    Ks, Ps = lqr_gains(A, B, Q, R, Q, iters)
    return Ks[0], Ps[0]
