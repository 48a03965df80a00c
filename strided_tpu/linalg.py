"""Linear algebra over strided views — dot_general dispatch + generic fused kernel.

XLA-native analog of `/root/reference/src/linalg.jl`:

- ``mul(C, A, B, alpha, beta)`` implements full gemm semantics
  ``C = alpha * A @ B + beta * C`` (`/root/reference/src/linalg.jl:44-63`).
  Dispatch mirrors the reference's BLAS-vs-generic split
  (`/root/reference/src/linalg.jl:47-49,87-95`): inexact dtypes route to
  ``lax.dot_general`` — cuBLAS on the GPU, this framework's "vendor BLAS" — with
  lazy transpose/conj fused into the operands by XLA (the analog of the
  ``'N'/'T'/'C'`` flag selection at `/root/reference/src/linalg.jl:65-84`);
  exact dtypes (ints — the stand-ins for the reference's
  ``Complex{Int}``/``Rational`` tests) and mixed-dtype cases run the
  **generic path**: matmul expressed as a 3-D stride-0 broadcast-reduce
  through the fused engine, exactly the reference's ``__mul!`` trick
  (`/root/reference/src/linalg.jl:130-162`): reshape ``A -> (m, 1, k)``,
  ``B -> (1, n, k)``, ``C -> (m, n, *k-broadcast*)`` and run
  ``mapreducedim(*, +, initop)``.
- ``beta`` threads through the engine's ``initop`` exactly once per output
  element, with the same 0/1 special-casing as
  `/root/reference/src/linalg.jl:144-159`.
- ``axpy``/``axpby``/``lmul``/``rmul`` lower to fused broadcasts with 0/1
  special cases (`/root/reference/src/linalg.jl:2-42`).

There is no divide-and-conquer threaded gemm (`linalg.jl:97-127`): its job —
filling all compute units of the chip — is done by XLA's GEMM library call; its
cross-chip analog (TP-style sharded matmul) lives in ``parallel/``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import jax
import jax.numpy as jnp
from jax import lax

from .core.view import StridedView, StridedLayoutError, strided
from .core.regularize import materialize, scatter_into
from .core.mapreduce import fused_mapreduce
from .core.broadcast import sbroadcast_into, sbroadcast
from .config import get_config

__all__ = [
    "mul",
    "matmul",
    "axpy",
    "axpby",
    "lmul",
    "rmul",
    "scale_into",
    "contract",
]


def _as_view(x):
    if isinstance(x, StridedView):
        return x
    from .core.lazy_expr import StridedExpr

    if isinstance(x, StridedExpr):
        return x.evaluate()
    return strided(x)


def _pair_route(out, alpha, x, beta=None, y=None):
    """Route the reference's ``axpy!``/``axpby!`` spellings into the
    structured pattern dispatch:
    ``axpby!(alpha, A', beta, B)`` (`/root/reference/src/linalg.jl:39-42`)
    is the same transpose-pair workload as the expression spelling
    ``alpha*A.T + beta*B``, so it takes the same measured-best route
    (same-buffer pair -> tile-pair kernel; distinct buffers -> fused XLA;
    see ``lazy_expr.try_pattern_expr``).

    Builds the equivalent :class:`StridedExpr` explicitly (NOT via the
    ``*`` operator: a numpy scalar on the left would hand the view to the
    numpy ufunc machinery, which materializes it host-side through
    ``__array__``) and runs the in-place pattern route; returns the
    updated view or None (callers fall back to the generic fused
    broadcast — behavior unchanged for every non-matching
    shape/layout/scalar, including the error type raised)."""
    import numbers

    import jax.numpy as _jnp

    from .core.lazy_expr import StridedExpr, identity_f, try_pattern_into

    if not isinstance(x, StridedView) or isinstance(alpha, bool):
        return None
    if not isinstance(alpha, numbers.Real):
        return None
    try:
        expr = StridedExpr(_jnp.multiply, (float(alpha), x))
        if y is not None:
            if isinstance(beta, bool) or not isinstance(beta, numbers.Real):
                return None
            expr = StridedExpr(
                _jnp.add,
                (expr, StridedExpr(_jnp.multiply, (float(beta), y))),
            )
        return try_pattern_into(out, identity_f, (expr,))
    except ValueError:
        # a shape/layout mismatch (StridedLayoutError is a ValueError, as is
        # an un-broadcastable pair) falls back to the generic path, which
        # raises the documented StridedLayoutError itself
        return None


# ---------------------------------------------------------------------------
# scalar multiplies (linalg.jl:2-42)
# ---------------------------------------------------------------------------


def rmul(v, alpha) -> StridedView:
    """``A .= A * alpha`` (`/root/reference/src/linalg.jl:2-10`)."""
    v = _as_view(v)
    if _is_static_one(alpha):
        return v
    if _is_static_zero(alpha):
        return sbroadcast_into(v, lambda x: jnp.zeros_like(x), v)
    return sbroadcast_into(v, lambda x: x * alpha, v)


def lmul(alpha, v) -> StridedView:
    """``A .= alpha * A`` (`/root/reference/src/linalg.jl:12-20`)."""
    v = _as_view(v)
    if _is_static_one(alpha):
        return v
    if _is_static_zero(alpha):
        return sbroadcast_into(v, lambda x: jnp.zeros_like(x), v)
    return sbroadcast_into(v, lambda x: alpha * x, v)


def scale_into(dst, alpha, src) -> StridedView:
    """``dst .= alpha .* src`` — ``mul!(dst, alpha, src)``
    (`/root/reference/src/linalg.jl:22-31`). A lazy-transposed ``src``
    (``B .= 3 .* A'``, the reference's README row 2) deliberately stays on
    the generic/XLA path: a pure scaled transpose reads and writes each
    element once either way, so the pair kernel saves nothing over XLA's
    transpose emitter."""
    dst = _as_view(dst)
    if _is_static_one(alpha):
        return sbroadcast_into(dst, lambda x: x, _as_view(src))
    return sbroadcast_into(dst, lambda x: alpha * x, _as_view(src))


def axpy(alpha, x, y) -> StridedView:
    """``y .= alpha*x + y`` (`/root/reference/src/linalg.jl:33-37`). A
    lazy-transposed square ``x`` over a dense ``y`` routes through the
    tile-pair kernel, exactly like the expression ``alpha*x + y``."""
    y = _as_view(y)
    if _is_static_zero(alpha):
        return y
    hit = _pair_route(y, alpha, x if isinstance(x, StridedView) else None, 1.0, y)
    if hit is not None:
        return hit
    return sbroadcast_into(y, lambda a, b: alpha * a + b, _as_view(x), y)


def axpby(alpha, x, beta, y) -> StridedView:
    """``y .= alpha*x + beta*y`` (`/root/reference/src/linalg.jl:39-42`). A
    lazy-transposed square ``x`` over a dense ``y`` routes through the
    tile-pair kernel, exactly like the expression
    spelling ``alpha*x.T + beta*y``."""
    y = _as_view(y)
    if _is_static_one(beta):
        return axpy(alpha, x, y)
    if _is_static_zero(beta):
        return scale_into(y, alpha, x)
    hit = _pair_route(y, alpha, x if isinstance(x, StridedView) else None, beta, y)
    if hit is not None:
        return hit
    return sbroadcast_into(y, lambda a, b: alpha * a + beta * b, _as_view(x), y)


def _is_static_zero(a) -> bool:
    return isinstance(a, (int, float, complex)) and a == 0


def _is_static_one(a) -> bool:
    return isinstance(a, (int, float, complex)) and a == 1


# ---------------------------------------------------------------------------
# matmul (linalg.jl:44-162)
# ---------------------------------------------------------------------------


def _precision(dtype=None):
    """Matmul precision from config: the analog of choosing accurate BLAS —
    the reference's baseline is exact/f64 CPU math, so 'highest' (IEEE FP32
    on the GPU) is the default for f32 operands; set
    STRIDED_TPU_MATMUL_PRECISION=default (or high) for TF32 tensor-core
    speed.

    bf16 operands always use DEFAULT precision: bf16 inputs multiplied
    exactly with f32 accumulation lose nothing."""
    if dtype is not None and dtype == jnp.bfloat16:
        return lax.Precision.DEFAULT
    name = get_config().matmul_precision.upper()
    return getattr(lax.Precision, name, lax.Precision.HIGHEST)


def _mxu_eligible(*dtypes) -> bool:
    """Analog of the BlasFloat check (`/root/reference/src/linalg.jl:47-49`):
    the dot_general path engages for equal inexact dtypes; exact dtypes and mixed
    combinations use the generic fused kernel (exactness preserved)."""
    if not get_config().use_mxu:
        return False
    first = dtypes[0]
    return all(d == first for d in dtypes) and jnp.issubdtype(
        first, jnp.inexact
    )


def mul(C, A, B, alpha=1, beta=0) -> StridedView:
    """``C = alpha * A @ B + beta * C`` with lazy transpose/conj operands —
    full ``LinearAlgebra.mul!`` semantics (`/root/reference/src/linalg.jl:44-63`).
    Returns ``C`` with its functionally-updated parent."""
    C, A, B = _as_view(C), _as_view(A), _as_view(B)
    if A.ndim != 2 or B.ndim != 2 or C.ndim != 2:
        raise StridedLayoutError("mul expects rank-2 views")
    m, ka = A.shape
    kb, n = B.shape
    mc, nc = C.shape
    if ka != kb or mc != m or nc != n:
        raise StridedLayoutError(
            f"mul shape mismatch: C{C.shape} = A{A.shape} @ B{B.shape}"
        )
    k = ka
    if m == 0 or n == 0:
        return C
    if k == 0:
        # C = beta * C (no accumulation) — zero-inner-dim edge case
        # (`/root/reference/test/blasmultests.jl:88-98`).
        return rmul(C, beta)

    if _mxu_eligible(C.dtype, A.dtype, B.dtype):
        return _mul_mxu(C, A, B, alpha, beta)
    return _mul_generic(C, A, B, alpha, beta)


def _mul_mxu(C, A, B, alpha, beta) -> StridedView:
    """dot_general path: XLA fuses the lazy layout recipes into the operands;
    the alpha/beta epilogue fuses into the result write."""
    a = materialize(A)
    b = materialize(B)
    acc_dtype = jnp.promote_types(C.dtype, jnp.float32) if jnp.issubdtype(
        C.dtype, jnp.floating
    ) else C.dtype
    res = lax.dot_general(
        a,
        b,
        (((1,), (0,)), ((), ())),
        preferred_element_type=acc_dtype,
        # both operand dtypes matter: DEFAULT is only safe when the
        # promoted dtype is bf16 — a mixed bf16 x f32 matmul must keep the
        # f32 operand's accuracy
        precision=_precision(jnp.promote_types(a.dtype, b.dtype)),
    )
    if not _is_static_one(alpha):
        res = alpha * res
    if _is_static_zero(beta):
        final = res
    else:
        old = materialize(C)
        final = res + (old if _is_static_one(beta) else beta * old)
    new_parent = scatter_into(C, final.astype(C.dtype))
    return StridedView(new_parent, C.shape, C.strides, C.offset, C.conj)


def _mul_generic(C, A, B, alpha, beta) -> StridedView:
    """Generic path: matmul as 3-D stride-0 broadcast-reduce through the
    fused engine — ``__mul!`` (`/root/reference/src/linalg.jl:130-162`).

    Iteration space (m, n, k); operand views built by metadata only:
      A(m,k)   -> (m, n, k) with strides (sA_m, 0, sA_k)
      B(k,n)   -> (m, n, k) with strides (0, sB_n, sB_k)
      C(m,n)   -> (m, n, k) with strides (sC_m, sC_n, 0)   [k is reduced]
    """
    m, k = A.shape
    _, n = B.shape
    dims = (m, n, k)
    A3 = StridedView(A.parent, dims, (A.strides[0], 0, A.strides[1]), A.offset, A.conj)
    B3 = StridedView(B.parent, dims, (0, B.strides[1], B.strides[0]), B.offset, B.conj)
    C3 = StridedView(C.parent, dims, (C.strides[0], C.strides[1], 0), C.offset, C.conj)
    # alpha folds into f (`/root/reference/src/linalg.jl:152`); beta becomes
    # the initop (`:144-159`).
    if _is_static_one(alpha):
        f = lambda x, y: x * y
    else:
        f = lambda x, y: alpha * (x * y)
    if _is_static_zero(beta):
        initop = lambda x: jnp.zeros_like(x)
    elif _is_static_one(beta):
        initop = None
    else:
        initop = lambda x: beta * x
    res = fused_mapreduce(f, jnp.add, initop, dims, C3, [A3, B3])
    return StridedView(res.parent, C.shape, C.strides, C.offset, C.conj)


def contract(subscripts: str, *operands, alpha=1) -> jax.Array:
    """General tensor contraction (einsum) with lazy strided-view operands
    and the configured matmul precision — the workload family of the
    reference's tensor-contraction benchmarks
    (`/root/reference/benchmarks/benchtests.jl:70-133`). Views lower to
    fusible recipes; XLA maps the contraction onto `dot_general`."""
    arrays = [materialize(_as_view(o)) for o in operands]
    common = (
        arrays[0].dtype
        if all(x.dtype == arrays[0].dtype for x in arrays)
        else None
    )
    out = jnp.einsum(subscripts, *arrays, precision=_precision(common))
    if not _is_static_one(alpha):
        out = alpha * out
    return out


def matmul(A, B, alpha=1) -> StridedView:
    """Allocating ``alpha * A @ B`` with promoted dtype."""
    A, B = _as_view(A), _as_view(B)
    rdt = jnp.promote_types(A.dtype, B.dtype)
    C = strided(jnp.zeros((A.shape[0], B.shape[1]), rdt))
    return mul(C, A, B, alpha=alpha, beta=0)
