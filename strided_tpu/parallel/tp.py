"""Sharded (tensor-parallel) matmul — the multi-chip analog of the
reference's divide-and-conquer threaded gemm.

The reference's opt-in `_threaded_blas_mul!` recursively splits the larger of
(m, n) across Julia tasks, each leaf calling BLAS on its disjoint output
block (`/root/reference/src/linalg.jl:97-127`). On a device mesh the same three
decompositions exist, with XLA collectives instead of task joins
(SURVEY.md §2.2 row 3):

- :func:`matmul_nsplit` — split the N (output-column) dim over the mesh:
  disjoint output shards, **no collective at all** (the direct analog of the
  reference's race-free task split);
- :func:`matmul_msplit` — split M (output rows): same, sharded over rows;
- :func:`matmul_ksplit` — split the contraction dim: each device computes a
  partial product, combined with ``psum`` over the mesh (the analog of the
  per-task accumulator slots + combine, `/root/reference/src/mapreduce.jl:153-170`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

__all__ = ["matmul_nsplit", "matmul_msplit", "matmul_ksplit"]


def _dot(a, b, precision):
    return lax.dot_general(
        a, b, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.promote_types(a.dtype, jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating)
        else a.dtype,
        precision=precision,
    ).astype(jnp.promote_types(a.dtype, b.dtype))


def matmul_nsplit(A, B, mesh: Mesh, axis: str = "data", precision=None):
    """C = A @ B with B (and C) column-sharded over ``axis``."""

    def local(a, b):
        return _dot(a, b, precision)

    f = shard_map(
        local, mesh=mesh, in_specs=(P(), P(None, axis)), out_specs=P(None, axis)
    )
    return f(A, B)


def matmul_msplit(A, B, mesh: Mesh, axis: str = "data", precision=None):
    """C = A @ B with A (and C) row-sharded over ``axis``."""

    def local(a, b):
        return _dot(a, b, precision)

    f = shard_map(
        local, mesh=mesh, in_specs=(P(axis, None), P()), out_specs=P(axis, None)
    )
    return f(A, B)


def matmul_ksplit(A, B, mesh: Mesh, axis: str = "data", precision=None):
    """C = A @ B with the contraction dim sharded: local partial matmuls
    combined by ``psum`` over the mesh axis (an all-reduce)."""

    def local(a, b):
        part = _dot(a, b, precision)
        return lax.psum(part, axis_name=axis)

    f = shard_map(
        local, mesh=mesh, in_specs=(P(None, axis), P(axis, None)), out_specs=P()
    )
    return f(A, B)
