"""Condensed-QP linear MPC — the north-star benchmark kernel.

BASELINE.json config 4: "quadrotor 12-state condensed-QP MPC, horizon 50,
permute/reduce QP condensing on a single chip".

Condensing eliminates the states from the finite-horizon QP: with discrete
LTI dynamics ``x_{k+1} = A x_k + B u_k`` the stacked prediction is
``X = Sx x0 + Su U``; substituting into the quadratic cost gives the dense
input-space QP

    min_U  0.5 U' H U + x0' M' U,   H = Su' Qbar Su + Rbar,  M = Su' Qbar Sx

All per-solve work is dense matmuls against **precomputed static** matrices
(H's Cholesky factor, the ADMM factor, M) — setup happens once per
(model, horizon), exactly as a production MPC deploys. Box input constraints
are handled by over-relaxed ADMM with a fixed iteration count (static shapes,
scan-friendly); the unconstrained solve collapses to one gain matmul
(receding-horizon LQR).

Batched solves vmap over ``x0`` — thousands of scenarios become one big
matmul per ADMM iteration (one cuBLAS SGEMM on the GPU).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import matmul_precision_scope

__all__ = ["CondensedQP", "build_condensed", "qp_solve", "qp_solve_unconstrained"]


@dataclasses.dataclass(frozen=True)
class CondensedQP:
    """Static condensed-QP data (pytree of arrays; hashable shapes)."""

    A: jax.Array          # (n, n)
    B: jax.Array          # (n, m)
    Su: jax.Array         # (N*n, N*m)
    Sx: jax.Array         # (N*n, n)
    H: jax.Array          # (N*m, N*m)
    M: jax.Array          # (N*m, n)   g = M @ x0
    K_lqr: jax.Array      # (N*m, n)   U* = -K_lqr @ x0 (unconstrained)
    solver: jax.Array     # (H + rho I)^{-1} (use_chol=False, the fast
                          # matmul path) OR cholesky(H + rho I) (use_chol=True, the
                          # conditioning fallback) — computed in f64 at setup
    rho: float
    N: int
    n: int
    m: int
    use_chol: bool = False

    def tree_flatten(self):
        leaves = (self.A, self.B, self.Su, self.Sx, self.H, self.M,
                  self.K_lqr, self.solver)
        return leaves, (self.rho, self.N, self.n, self.m, self.use_chol)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)


jax.tree_util.register_pytree_node(
    CondensedQP,
    lambda q: q.tree_flatten(),
    CondensedQP.tree_unflatten,
)


def build_condensed(A, B, Q, R, QN, N: int, rho: float = 1.0) -> CondensedQP:
    """One-time setup: prediction matrices, H, its factors. Runs in f64 on
    host (numpy) for conditioning, stored in the working dtype of A."""
    dtype = A.dtype
    A_, B_ = np.asarray(A, np.float64), np.asarray(B, np.float64)
    Q_, R_, QN_ = np.asarray(Q, np.float64), np.asarray(R, np.float64), np.asarray(QN, np.float64)
    n, m = B_.shape
    # Powers of A: Apow[i] = A^i
    Apow = [np.eye(n)]
    for _ in range(N):
        Apow.append(A_ @ Apow[-1])
    Sx = np.concatenate([Apow[i + 1] for i in range(N)], axis=0)  # (N*n, n)
    Su = np.zeros((N * n, N * m))
    for i in range(N):  # block row i predicts x_{i+1}
        for j in range(i + 1):
            Su[i * n : (i + 1) * n, j * m : (j + 1) * m] = Apow[i - j] @ B_
    Qbar = np.kron(np.eye(N), Q_)
    Qbar[-n:, -n:] = QN_
    Rbar = np.kron(np.eye(N), R_)
    H = Su.T @ Qbar @ Su + Rbar
    H = 0.5 * (H + H.T)
    M = Su.T @ Qbar @ Sx
    K_lqr = np.linalg.solve(H, M)
    H_admm = H + rho * np.eye(N * m)
    # Explicit inverse (f64, well-conditioned thanks to the +rho I ridge):
    # turns each ADMM iteration's triangular-solve pair — sequential — into
    # ONE dense batched matmul. Guard: if the
    # ridge did NOT tame the conditioning (tiny rho / huge N*m), fall back
    # to the Cholesky triangular-solve pair, which stays accurate.
    cond = float(np.linalg.cond(H_admm))
    use_chol = cond > 1e7
    if use_chol:
        import warnings

        warnings.warn(
            f"cond(H + rho I) = {cond:.2e}: ADMM uses Cholesky triangular "
            "solves instead of the explicit inverse (slower, accurate); "
            "consider a larger rho",
            stacklevel=2,
        )
        solver = np.linalg.cholesky(H_admm)
    else:
        solver = np.linalg.inv(H_admm)
    to = lambda x: jnp.asarray(x, dtype)
    return CondensedQP(
        A=to(A_), B=to(B_), Su=to(Su), Sx=to(Sx), H=to(H), M=to(M),
        K_lqr=to(K_lqr), solver=to(solver),
        rho=rho, N=N, n=n, m=m, use_chol=use_chol,
    )


@matmul_precision_scope
def qp_solve_unconstrained(qp: CondensedQP, x0: jax.Array) -> jax.Array:
    """U* = -H^{-1} M x0 via the precomputed gain. x0 ``(*batch, n)`` ->
    U ``(*batch, N, m)``."""
    U = -x0 @ qp.K_lqr.T
    return U.reshape(*x0.shape[:-1], qp.N, qp.m)


def _chol_solve(L, b):
    """Solve (L L') z = b for a batch of right-hand sides (b: (*batch, k)).

    The batch is folded into the RHS *columns* of one big triangular solve —
    a single (k, k) x (k, B) operation instead of B small ones."""
    bshape = b.shape
    bt = b.reshape(-1, bshape[-1]).T  # (k, B)
    y = jax.scipy.linalg.solve_triangular(L, bt, lower=True)
    z = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    return z.T.reshape(bshape)


@matmul_precision_scope
def qp_solve(
    qp: CondensedQP,
    x0: jax.Array,
    u_min: jax.Array,
    u_max: jax.Array,
    iters: int = 20,
    alpha: float = 1.6,
    coarse_iters: int = 0,
) -> jax.Array:
    """Box-constrained condensed QP via over-relaxed ADMM, fixed ``iters``.

    x0 ``(*batch, n)``; u_min/u_max ``(m,)`` bounds (applied per stage).
    Per iteration: one (N*m, N*m) dense solve (a matmul against the
    precomputed inverse) + clips — all batched over scenarios into one
    matmul. Returns U ``(*batch, N, m)``.

    ALL matmuls here (g, the warm start, and the per-iteration solve) run
    under the configured matmul precision: ADMM converges to the fixed point
    of the *computed* g, so a low-precision ``g = M x0`` biases every
    iterate.

    ``coarse_iters``: run the FIRST ``coarse_iters`` iterations at DEFAULT
    precision (TF32 on the GPU) and only the remaining ones at the
    configured precision — an opt-in throughput/accuracy trade, NOT a free
    lunch: ADMM's contraction is too slow for the accurate tail to absorb
    the coarse-phase bias, so expect the headline 1e-4 first-input gate to
    fail for a useful split (not measured on the GPU). ``g`` and the warm
    start always use the configured precision (the fixed point itself must
    not be biased)."""
    g = x0 @ qp.M.T  # (*batch, N*m)
    lo = jnp.tile(u_min, qp.N)
    hi = jnp.tile(u_max, qp.N)
    z = jnp.clip(-x0 @ qp.K_lqr.T, lo, hi)
    y = jnp.zeros_like(z)

    def body(carry, _):
        z, y = carry
        rhs = qp.rho * (z - y) - g
        if qp.use_chol:
            # conditioning fallback chosen at setup: triangular-solve pair
            u = _chol_solve(qp.solver, rhs)
        else:
            # (H + rho I)^{-1} rhs as one dense matmul (the inverse is
            # symmetric and was formed in f64 at setup, so accuracy matches
            # the triangular-solve pair)
            u = rhs @ qp.solver
        u_rel = alpha * u + (1 - alpha) * z
        z_new = jnp.clip(u_rel + y, lo, hi)
        y_new = y + u_rel - z_new
        return (z_new, y_new), None

    coarse = max(0, min(int(coarse_iters), int(iters)))
    if coarse:
        with jax.default_matmul_precision("default"):
            (z, y), _ = lax.scan(body, (z, y), None, length=coarse)
    if iters - coarse:
        (z, y), _ = lax.scan(body, (z, y), None, length=iters - coarse)
    return z.reshape(*x0.shape[:-1], qp.N, qp.m)
