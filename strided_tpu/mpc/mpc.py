"""Receding-horizon MPC controller: linearize -> condense -> solve -> step.

Closed-loop quadrotor MPC (BASELINE.json config 4): the controller linearizes
the model at hover once, builds the condensed QP once, and each control step
solves the box-constrained QP for the current state deviation — all inside
one jitted ``lax.scan`` over the simulation horizon, batched over scenarios.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import matmul_precision_scope
from ..models.base import Model
from .qp import CondensedQP, build_condensed, qp_solve, qp_solve_unconstrained

__all__ = ["LinearMPC", "make_hover_mpc", "closed_loop"]


@dataclasses.dataclass(frozen=True)
class LinearMPC:
    """MPC controller around an operating point (x_eq, u_eq)."""

    qp: CondensedQP
    x_eq: jax.Array
    u_eq: jax.Array
    u_min: jax.Array  # bounds on the *deviation* input
    u_max: jax.Array
    admm_iters: int = 20
    constrained: bool = True
    # first admm_coarse_iters ADMM iterations run at fast DEFAULT matmul
    # precision; the rest at the configured precision (see qp_solve)
    admm_coarse_iters: int = 0

    def control(self, x, x_ref=None):
        """First-stage input for current state ``x`` ``(*batch, n)``.

        ``x_ref``: optional target state (defaults to the equilibrium)."""
        dx = x - (self.x_eq if x_ref is None else x_ref)
        if self.constrained:
            U = qp_solve(self.qp, dx, self.u_min, self.u_max, self.admm_iters,
                         coarse_iters=self.admm_coarse_iters)
        else:
            U = qp_solve_unconstrained(self.qp, dx)
        return U[..., 0, :] + self.u_eq, U

    def plan(self, x, x_ref=None):
        """Full horizon plan U ``(*batch, N, m)`` (deviation inputs)."""
        return self.control(x, x_ref)[1]


jax.tree_util.register_pytree_node(
    LinearMPC,
    lambda c: (
        (c.qp, c.x_eq, c.u_eq, c.u_min, c.u_max),
        (c.admm_iters, c.constrained, c.admm_coarse_iters),
    ),
    lambda aux, leaves: LinearMPC(*leaves, *aux),
)


def make_hover_mpc(
    model: Model,
    x_eq,
    u_eq,
    Q,
    R,
    QN,
    horizon: int,
    dt: float,
    u_min=None,
    u_max=None,
    admm_iters: int = 20,
    rho: float = 1.0,
    admm_coarse_iters: int = 0,
) -> LinearMPC:
    A, B = model.linearize(jnp.asarray(x_eq), jnp.asarray(u_eq), dt)
    qp = build_condensed(A, B, Q, R, QN, horizon, rho)
    m = qp.m
    constrained = u_min is not None or u_max is not None
    big = jnp.full((m,), 1e9, A.dtype)
    return LinearMPC(
        qp=qp,
        x_eq=jnp.asarray(x_eq),
        u_eq=jnp.asarray(u_eq),
        u_min=(jnp.asarray(u_min, A.dtype) if u_min is not None else -big),
        u_max=(jnp.asarray(u_max, A.dtype) if u_max is not None else big),
        admm_iters=admm_iters,
        constrained=constrained,
        admm_coarse_iters=admm_coarse_iters,
    )


@matmul_precision_scope
def closed_loop(ctrl: LinearMPC, model: Model, x0, steps: int, dt: float):
    """Simulate the nonlinear plant under the MPC law for ``steps`` steps.

    x0 ``(*batch, n)``. Returns (states ``(*batch, steps+1, n)``,
    inputs ``(*batch, steps, m)``)."""

    def body(x, _):
        u, _U = ctrl.control(x)
        xn = model.step(x, u, dt)
        return xn, (xn, u)

    _, (xs, us) = lax.scan(body, x0, None, length=steps)
    xs = jnp.concatenate([x0[None], xs], axis=0)
    return jnp.moveaxis(xs, 0, -2), jnp.moveaxis(us, 0, -2)
