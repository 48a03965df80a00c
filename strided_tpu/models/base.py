"""Dynamics-model base: continuous dynamics + RK4 step + batched linearization.

The model layer feeding the MPC stack (BASELINE.json north star). The
reference has no model code (SURVEY.md §0: Strided.jl is a pure kernel
library); these models are the workloads that exercise the strided engine the
way the reference's benchmarks exercise its kernels — batched rollouts are
fused elementwise maps over ``(batch, horizon, state)`` HBM tensors, and
linearizations are batched Jacobians feeding dense matmuls.

Everything is static-shape, scan-friendly, and dtype-generic: f32 on the
device path, f64 for oracles and the upstream's own dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

__all__ = ["Model", "rk4_step", "linearize"]


def rk4_step(f: Callable, x: jax.Array, u: jax.Array, dt) -> jax.Array:
    """Classic RK4 discretization of ``x' = f(x, u)`` (zero-order-hold u)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@dataclasses.dataclass(frozen=True)
class Model:
    """A control-affine-ish dynamics model.

    ``dynamics(x, u) -> xdot`` is pure and traceable; ``step`` is the RK4
    discrete map; ``linearize`` returns (A, B) of the discrete step —
    computed with ``jax.jacfwd`` (forward-mode: state dims are few, batch is
    huge, so jacfwd over the step vmaps cleanly over scenario batches).
    """

    name: str
    state_dim: int
    input_dim: int
    dynamics: Callable  # (x, u) -> xdot

    def step(self, x, u, dt):
        return rk4_step(self.dynamics, x, u, dt)

    def linearize(self, x, u, dt) -> Tuple[jax.Array, jax.Array]:
        A = jax.jacfwd(lambda xx: self.step(xx, u, dt))(x)
        B = jax.jacfwd(lambda uu: self.step(x, uu, dt))(u)
        return A, B


def linearize(model: Model, xs, us, dt):
    """Batched linearization along a trajectory (or batch of them): vmap of
    jacfwd over all leading dims of ``xs``/``us``."""
    f = lambda x, u: model.linearize(x, u, dt)
    nbatch = xs.ndim - 1
    for _ in range(nbatch):
        f = jax.vmap(f)
    return f(xs, us)
