"""Batched iLQR — blocked Riccati backward sweep as a `lax.scan`.

BASELINE.json config 3: "cartpole iLQR: batched Jacobians via strided
broadcast + mapreduce, blocked backward Riccati sweep". The three phases per
iteration:

1. rollout (scan over horizon, fused RK4 body — see ``rollout.py``);
2. linearization along the trajectory: ``jax.jacfwd`` of the discrete step,
   vmapped over time (and over the scenario batch by the caller) — small
   (n+m)-wide Jacobians batched into matmul-friendly stacks;
3. backward Riccati sweep: time-reversed ``lax.scan`` whose body is dense
   (n,n)/(n,m) matmuls — the analog of the reference's blocked reduction
   over a big dimension (the horizon), sequential by construction exactly
   like reduction dims in the engine (races impossible);
4. forward pass with the time-varying affine policy and a 3-point
   backtracking line search evaluated in parallel.

Everything is fixed-iteration and static-shape (jit/scan-compatible; no
data-dependent control flow — SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import matmul_precision_scope
from ..models.base import Model
from .rollout import rollout

__all__ = ["QuadCost", "ilqr", "ilqr_batched"]


@dataclasses.dataclass(frozen=True)
class QuadCost:
    """Quadratic tracking cost: 0.5(x-xg)'Q(x-xg) + 0.5 u'Ru, terminal Qf."""

    Q: jax.Array
    R: jax.Array
    Qf: jax.Array
    x_goal: jax.Array

    def stage(self, x, u):
        dx = x - self.x_goal
        return 0.5 * dx @ self.Q @ dx + 0.5 * u @ self.R @ u

    def terminal(self, x):
        dx = x - self.x_goal
        return 0.5 * dx @ self.Qf @ dx

    def total(self, xs, us):
        # xs (T+1, n), us (T, m)
        dx = xs[:-1] - self.x_goal
        stage = 0.5 * jnp.einsum("ti,ij,tj->", dx, self.Q, dx)
        stage += 0.5 * jnp.einsum("ti,ij,tj->", us, self.R, us)
        return stage + self.terminal(xs[-1])


class ILQRResult(NamedTuple):
    xs: jax.Array  # (T+1, n)
    us: jax.Array  # (T, m)
    cost: jax.Array  # scalar
    costs: jax.Array  # per-iteration cost trace


def _backward(As, Bs, xs, us, cost: QuadCost, mu):
    """Riccati backward sweep -> gains (k, K). All-matmul scan body."""
    n = xs.shape[-1]
    dxs = xs[:-1] - cost.x_goal
    lx = dxs @ cost.Q  # (T, n)
    lu = us @ cost.R  # (T, m)
    VxT = (xs[-1] - cost.x_goal) @ cost.Qf
    VxxT = cost.Qf
    I = jnp.eye(us.shape[-1], dtype=us.dtype)

    def body(carry, inp):
        Vx, Vxx = carry
        A, B, lx_t, lu_t = inp
        Qx = lx_t + A.T @ Vx
        Qu = lu_t + B.T @ Vx
        Qxx = cost.Q + A.T @ Vxx @ A
        Quu = cost.R + B.T @ Vxx @ B + mu * I
        Qux = B.T @ Vxx @ A
        Quu_inv = jnp.linalg.inv(Quu)
        K = -Quu_inv @ Qux
        k = -Quu_inv @ Qu
        Vx_n = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        Vxx_n = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx_n = 0.5 * (Vxx_n + Vxx_n.T)
        return (Vx_n, Vxx_n), (k, K)

    (_, _), (ks, Ks) = lax.scan(
        body, (VxT, VxxT), (As, Bs, lx, lu), reverse=True
    )
    return ks, Ks


def _forward(model, x0, xs, us, ks, Ks, alpha, dt, cost: QuadCost):
    """Closed-loop forward pass with the affine policy at step size alpha."""

    def body(x, inp):
        x_ref, u_ref, k, K = inp
        u = u_ref + alpha * k + K @ (x - x_ref)
        xn = model.step(x, u, dt)
        return xn, (xn, u)

    _, (xs_new, us_new) = lax.scan(body, x0, (xs[:-1], us, ks, Ks))
    xs_new = jnp.concatenate([x0[None], xs_new], axis=0)
    return xs_new, us_new, cost.total(xs_new, us_new)


@matmul_precision_scope
def ilqr(
    model: Model,
    cost: QuadCost,
    x0: jax.Array,
    us_init: jax.Array,
    dt: float,
    iters: int = 20,
    mu: float = 1e-3,
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1),
) -> ILQRResult:
    """Fixed-iteration iLQR for one initial state (vmap for batches or use
    :func:`ilqr_batched`)."""
    T = us_init.shape[0]
    xs0 = rollout(model, x0, us_init, dt)
    c0 = cost.total(xs0, us_init)

    def lin(x, u):
        return model.linearize(x, u, dt)

    lin_t = jax.vmap(lin)

    def iteration(carry, _):
        xs, us, c, mu_c = carry
        As, Bs = lin_t(xs[:-1], us)
        ks, Ks = _backward(As, Bs, xs, us, cost, mu_c)
        # Parallel line search over alphas; keep the best improvement.
        cands = [
            _forward(model, x0, xs, us, ks, Ks, a, dt, cost) for a in alphas
        ]
        costs = jnp.stack([cc for (_, _, cc) in cands])
        # Diverged rollouts produce NaN/inf costs: treat as +inf so the line
        # search rejects them (the scan must stay NaN-free).
        costs = jnp.where(jnp.isfinite(costs), costs, jnp.inf)
        best = jnp.argmin(costs)
        xs_c = jnp.stack([xc for (xc, _, _) in cands])
        us_c = jnp.stack([uc for (_, uc, _) in cands])
        c_new = costs[best]
        improved = c_new < c
        xs_n = jnp.where(improved, xs_c[best].reshape(xs.shape), xs)
        us_n = jnp.where(improved, us_c[best].reshape(us.shape), us)
        c_n = jnp.where(improved, c_new, c)
        # Levenberg-style regularization schedule: shrink on success, grow on
        # rejection (keeps the backward pass PD when far from the valley).
        mu_n = jnp.where(improved, jnp.maximum(mu_c * 0.5, mu), mu_c * 4.0)
        mu_n = jnp.minimum(mu_n, 1e6)
        return (xs_n, us_n, c_n, mu_n), c_n

    init = (xs0, us_init, c0, jnp.asarray(mu, xs0.dtype))
    (xs, us, c, _), trace = lax.scan(iteration, init, None, length=iters)
    return ILQRResult(xs, us, c, trace)


def ilqr_batched(model, cost, x0s, us_init, dt, **kw):
    """vmap over a batch of initial states (scenario batch)."""
    f = lambda x0, us: ilqr(model, cost, x0, us, dt, **kw)
    return jax.vmap(f)(x0s, us_init)
