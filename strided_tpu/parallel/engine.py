"""Mesh-sharded engine ops — the cross-chip tier of the kernel engine.

The reference scales one fused kernel across CPU cores by recursively
splitting the loop dim with the largest ``(dims - 1) * costs`` over Julia
tasks, never splitting reduction dims, and combining complete reductions
through per-task accumulator slots (`/root/reference/src/mapreduce.jl:195-227,
153-170, 172-177`). This module is the same scheduler re-expressed over a
``jax.sharding.Mesh`` (SURVEY.md §2.2 rows 1-2):

- :func:`choose_split_dim` — the exact split-dim rule (max ``(d-1)*cost``
  with the last argmax, `/root/reference/src/mapreduce.jl:203,452-460`)
  restricted to non-reduction dims (the cost-zeroing race rule,
  `/root/reference/src/mapreduce.jl:172-177`).
- :func:`sharded_smap` / :func:`sharded_reduce` — run the fused engine with
  the chosen iteration dim annotated onto a mesh axis; XLA's GSPMD
  partitioner splits the fused kernel across chips and inserts the
  ``psum``-class collectives for reduction dims (the accumulator-combine of
  the reference, riding the interconnect instead of shared memory).

Tasks→``wait`` becomes sharding-annotation→collective: the scheduling itself
moves into the compiler, which is the idiomatic JAX division of labor.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.view import StridedView
from ..core.lazy_expr import StridedExpr, as_expr_parts
from ..core.regularize import materialize

__all__ = [
    "choose_split_dim",
    "sharded_smap",
    "sharded_reduce",
    "sharded_batched_pair",
    "sharded_stream_sum",
]


def choose_split_dim(
    dims: Tuple[int, ...],
    all_strides: Tuple[Tuple[int, ...], ...],
    reduction_dims: Tuple[int, ...] = (),
) -> Optional[int]:
    """Pick the dim to shard: largest ``(d - 1) * cost`` among non-reduction
    dims, last argmax on ties — the task scheduler's split rule
    (`/root/reference/src/mapreduce.jl:203`, ``_lastargmax`` `:452-460`)
    with reduction dims excluded by construction (`:172-177`)."""
    # cost = 2 * min nonzero |stride| (0 -> 1), evaluated in the ORIGINAL
    # axis order so the returned index is the original axis id.
    best, best_i = -1, None
    for i in range(len(dims)):
        if i in reduction_dims or dims[i] <= 1:
            continue
        mn = min(abs(s[i]) for s in all_strides)
        cost = 1 if mn == 0 else 2 * mn
        score = (dims[i] - 1) * cost
        if score >= best:
            best, best_i = score, i
    return best_i


def _constrain(arr: jax.Array, mesh: Mesh, dim: int, axis_name: str):
    spec = [None] * arr.ndim
    if arr.ndim:
        spec[dim] = axis_name
    return lax.with_sharding_constraint(arr, NamedSharding(mesh, P(*spec)))


def sharded_smap(
    f: Callable,
    mesh: Mesh,
    *args,
    axis_name: str = "data",
    split_dim: Optional[int] = None,
):
    """Fused elementwise map over views/expressions with the iteration space
    sharded over ``mesh`` along the planner-chosen dim. Returns a
    :class:`StridedView` (API symmetry with the local engine — composing
    sharded and local calls stays lazy); its flat parent buffer keeps the
    GSPMD sharding along the split dim.

    Must run under ``jax.jit`` for GSPMD to partition (eager mode still
    computes correctly)."""
    parts = [as_expr_parts(a) for a in args]
    shape = jnp.broadcast_shapes(*[p[2] for p in parts])
    if split_dim is None:
        all_strides = tuple(
            tuple(v.strides) for _, leaves, _ in parts for v in leaves
            if tuple(v.shape) == tuple(shape)
        ) or ((tuple(0 for _ in shape)),)
        split_dim = choose_split_dim(tuple(shape), all_strides)
    dense = []
    for g, leaves, _ in parts:
        arrs = []
        for v in leaves:
            arr = materialize(v)
            arr = jnp.broadcast_to(arr, shape)
            if split_dim is not None:
                arr = _constrain(arr, mesh, split_dim, axis_name)
            arrs.append(arr)
        dense.append(g(*arrs))
    out = f(*dense)
    if split_dim is not None:
        out = _constrain(out, mesh, split_dim, axis_name)
    from ..core.view import strided

    return strided(out)


def sharded_batched_pair(
    x: jax.Array,
    mesh: Mesh,
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
    scale_mode=None,
    scale: float = 1.0,
    axis_name: str = "data",
) -> jax.Array:
    """Per-device tile-pair kernels composed under ``shard_map`` — the
    two-tier schedule of SURVEY §2.2 row 1 in one call: ``shard_map`` shards
    the batch axis over the mesh (the reference's task tier,
    `/root/reference/src/mapreduce.jl:195-227`), and INSIDE each device's
    region the pair kernel's grid tiles the matrix (the blocked kernel
    tier). ``x`` is ``(B, n, n)`` with ``B`` divisible by the mesh size; each
    device runs :func:`...kernels_special.pair_axpby` over its local
    matrices via ``lax.map``. Must run under ``jax.jit``."""
    from ..core.kernels_special import pair_axpby

    if x.ndim != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"expected (B, n, n), got {x.shape}")

    def per_device(block):
        return lax.map(
            lambda m: pair_axpby(
                m, alpha=alpha, beta=beta, scale_mode=scale_mode, scale=scale
            ),
            block,
        )

    return jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
        check_vma=False,  # opaque pallas_call inside
    )(x)


def sharded_stream_sum(
    x: jax.Array,
    mesh: Mesh,
    *,
    axis_name: str = "data",
) -> jax.Array:
    """Leading-axis column sum of a row-sharded matrix: a local ``jnp.sum``
    per device inside ``shard_map`` and a ``psum`` combining the per-device
    partials over the mesh — the reference's accumulator-slot combine
    (`/root/reference/src/mapreduce.jl:153-170`) as an all-reduce. ``x`` is
    ``(N, M)`` sharded on axis 0; returns the dense ``(M,)`` sum
    (replicated)."""

    def per_device(block):
        return lax.psum(jnp.sum(block, axis=0, dtype=block.dtype), axis_name)

    return jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(),
    )(x)


def sharded_reduce(
    f: Callable,
    op: Callable,
    v,
    mesh: Mesh,
    axes: Optional[Sequence[int]] = None,
    axis_name: str = "data",
    split_dim: Optional[int] = None,
):
    """Fused map+reduce over a view/expression with the input sharded over
    the mesh. Partial reductions shard a KEPT dim (device-disjoint outputs,
    race-free by construction); complete reductions shard a reduced dim and
    let GSPMD insert the ``psum`` — the accumulator-slot combine of
    `/root/reference/src/mapreduce.jl:153-170` as an all-reduce.

    Returns a :class:`StridedView` over the kept dims (matching the local
    ``sreduce_dims``), or a 0-d array for a complete reduction (matching
    the local ``sreduce``)."""
    g, leaves, shape = as_expr_parts(v)
    ndim = len(shape)
    if axes is None:
        axes = tuple(range(ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    axes = tuple(sorted(range(ndim)[a] for a in axes))
    kept = tuple(i for i in range(ndim) if i not in axes)
    if split_dim is None:
        all_strides = tuple(
            tuple(x.strides) for x in leaves if tuple(x.shape) == tuple(shape)
        ) or ((tuple(0 for _ in shape)),)
        if kept:
            split_dim = choose_split_dim(tuple(shape), all_strides, reduction_dims=axes)
        else:
            # complete reduction: shard the biggest reduced dim; the combine
            # is a collective, not a race.
            split_dim = max(axes, key=lambda i: shape[i]) if axes else None
    arrs = []
    for x in leaves:
        arr = jnp.broadcast_to(materialize(x), shape)
        if split_dim is not None and shape[split_dim] > 1:
            arr = _constrain(arr, mesh, split_dim, axis_name)
        arrs.append(arr)
    vals = f(g(*arrs))
    from ..core.mapreduce import _reduce_vals

    out = _reduce_vals(op, vals, axes)
    if not kept:
        return out  # complete reduction: 0-d array, like local sreduce
    if split_dim is not None and split_dim in kept:
        out_dim = kept.index(split_dim)
        out = _constrain(out, mesh, out_dim, axis_name)
    from ..core.view import strided

    return strided(out)
