"""Fused multi-operand map / reduce engine — the heart of the framework.

XLA-native analog of the reference's kernel engine
(`/root/reference/src/mapreduce.jl`). The central primitive is
:func:`fused_mapreduce`, mirroring ``_mapreducedim!``
(`/root/reference/src/mapreduce.jl:86-96`) including its two key encodings:

- **Reduction dims are output dims with stride 0** — the output view is
  lazily reshaped so reduced dims have stride 0 and the kernel accumulates
  into the same output element (`/root/reference/src/mapreduce.jl:64-70`).
- **``initop`` is applied exactly once per output element** before the first
  accumulation — this is how gemm-style ``β*C + ...`` semantics thread
  through the engine (`/root/reference/src/mapreduce.jl:351-423`,
  `/root/reference/src/linalg.jl:144-159`).

Execution lowers to XLA: materialize the lazy operands (each is a fusible
slice/reshape/transpose recipe, see ``regularize.py``), apply the traced
``f``, reduce with ``op`` — XLA fuses the whole thing into one pass over
device memory, which replaces the reference's fused ``@generated`` loop nest
(`/root/reference/src/mapreduce.jl:229-425`) and its block+thread scheduler
(XLA's GPU emitters tile transposes through shared memory and pick the
reduction strategy per layout).
"""

from __future__ import annotations

import builtins
import logging
import math
import operator
from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .view import StridedView, StridedLayoutError, strided, broadcast_to, sreshape
from .regularize import materialize, scatter_into
from .lazy_expr import StridedExpr, as_expr_parts
from ..config import get_config

# Engine dispatch decisions (which backend ran a given fused call) log here
# at DEBUG — the observability hook the reference lacks entirely (SURVEY §5
# metrics/logging row); enable with
# ``logging.getLogger("strided_tpu.dispatch").setLevel(logging.DEBUG)``.
_dispatch_log = logging.getLogger("strided_tpu.dispatch")

__all__ = [
    "fused_mapreduce",
    "smap",
    "map_into",
    "copy_into",
    "permutedims_into",
    "adjoint_into",
    "conj_into",
    "sreduce",
    "sreduce_dims",
    "mapreducedim_into",
    "reduce_identity",
]


# ---------------------------------------------------------------------------
# reduction-op identity registry
# ---------------------------------------------------------------------------
# Mirrors `_init_reduction!`'s table of known identity elements for
# `+ * min max & |` (`/root/reference/src/mapreduce.jl:182-191`). Ops not in
# the table fall back to a sequential fold (the reference *errors* for them
# under threading; we can always fold sequentially inside one program).


def reduce_identity(op: Callable, dtype):
    """Identity element as a PYTHON scalar (not a jax array) so kernels can
    close over it without capturing device constants."""
    if op in (operator.add, jnp.add):
        return 0
    if op in (operator.mul, jnp.multiply):
        return 1
    if op is jnp.minimum:
        if jnp.issubdtype(dtype, jnp.floating):
            return float("inf")
        return int(jnp.iinfo(dtype).max)
    if op is jnp.maximum:
        if jnp.issubdtype(dtype, jnp.floating):
            return float("-inf")
        return int(jnp.iinfo(dtype).min)
    if op in (jnp.logical_and,):
        return True
    if op in (jnp.logical_or,):
        return False
    if op in (operator.and_, jnp.bitwise_and):
        return -1  # all ones
    if op in (operator.or_, jnp.bitwise_or):
        return 0
    return None


def _reduce_vals(op: Callable, vals: jax.Array, axes: Tuple[int, ...]) -> jax.Array:
    """Reduce ``vals`` over ``axes`` with binary ``op`` (keepdims=False).

    Known ops use ``lax.reduce`` (tree reduction, XLA-fused); unknown ops use
    a sequential fold seeded by the first slice — no identity needed. The
    reference makes the same split: known identities thread, unknown ops run
    serially (`/root/reference/src/mapreduce.jl:182-191`)."""
    # Native reducers first: XLA recognizes them (e.g. sum∘transpose is
    # rewritten to a direct streaming sum; a lax.reduce with an opaque
    # lambda computation is not algebraically simplified the same way).
    table = [
        ((operator.add, jnp.add), jnp.sum),
        ((operator.mul, jnp.multiply), jnp.prod),
        ((jnp.minimum,), jnp.min),
        ((jnp.maximum,), jnp.max),
        ((jnp.logical_and,), jnp.all),
        ((jnp.logical_or,), jnp.any),
    ]
    for ops_, red in table:
        if any(op is o for o in ops_):
            return red(vals, axis=axes)
    ident = reduce_identity(op, vals.dtype)
    if ident is not None:
        return lax.reduce(
            vals, jnp.asarray(ident, vals.dtype), lambda a, b: op(a, b), axes
        )
    # Unknown-identity fold: adjacent-pair tree reduction. The reference
    # *errors* for unknown ops under threading
    # (`/root/reference/src/mapreduce.jl:188-191`); handling them is strictly
    # more capable, but a lax.scan over n-1 flattened elements would be a
    # scalability trap (67M sequential steps at 8192^2). The tree fold
    # needs only associativity (pairing
    # is ADJACENT, so left-to-right order is preserved — no commutativity
    # assumed; reassociation is within Base.mapreduce's documented
    # implementation-defined-associativity contract) and runs in
    # ceil(log2(n)) vectorized XLA ops with no identity element: odd tails
    # are carried to the next round unchanged.
    keep = [i for i in range(vals.ndim) if i not in axes]
    perm = keep + list(axes)
    v = jnp.transpose(vals, perm)
    ksh = v.shape[: len(keep)]
    v = v.reshape(ksh + (-1,))
    if v.shape[-1] == 0:
        raise StridedLayoutError(
            "cannot reduce over empty dims with an op of unknown identity"
        )
    while v.shape[-1] > 1:
        k = v.shape[-1]
        m = k // 2
        folded = op(v[..., 0 : 2 * m : 2], v[..., 1 : 2 * m : 2])
        if k % 2:
            folded = jnp.concatenate([folded, v[..., -1:]], axis=-1)
        v = folded
    return v[..., 0]


# ---------------------------------------------------------------------------
# the central fused primitive
# ---------------------------------------------------------------------------


def _as_view(x) -> StridedView:
    if isinstance(x, StridedView):
        return x
    if isinstance(x, StridedExpr):
        return x.evaluate()
    return strided(x)


def fused_mapreduce(
    f: Callable,
    op: Optional[Callable],
    initop: Optional[Callable],
    dims: Tuple[int, ...],
    out: StridedView,
    ins: Sequence[StridedView],
) -> StridedView:
    """``out[I] = op(initop(out[I]), fold_op over reduced dims of f(ins[I]))``.

    Direct analog of ``_mapreducedim!`` (`/root/reference/src/mapreduce.jl:86-96`):
    ``dims`` is the full logical iteration space; reduction dims are exactly
    those where ``out`` has stride 0 and size > 1 (the reference encoding);
    input broadcast dims are input strides 0. ``op=None`` means pure map.
    Returns ``out`` with its (functionally) updated parent buffer.
    """
    dims = tuple(int(d) for d in dims)
    out = _as_view(out)
    ins = [_as_view(v) for v in ins]
    for v in ins:
        if tuple(v.shape) != dims:
            raise StridedLayoutError(f"input shape {v.shape} != iteration dims {dims}")
    if tuple(out.shape) != dims:
        raise StridedLayoutError(f"output shape {out.shape} != iteration dims {dims}")

    # Size-0 iteration space: only initop applies (mirror
    # `_mapreducedim!`'s size-0 handling, /root/reference/src/mapreduce.jl:86-96).
    red = tuple(i for i in range(len(dims)) if out.strides[i] == 0 and dims[i] != 1)
    if any(d == 0 for d in dims):
        if initop is None:
            return out
        if any(dims[i] == 0 for i in red):
            # reducing over an empty dim: every output element gets initop
            out_read = _squeeze_view(out, red)
            old = materialize(out_read)
            new_parent = scatter_into(out_read, initop(old))
            return StridedView(new_parent, out.shape, out.strides, out.offset, out.conj)
        return out  # empty kept dim: no output elements at all

    _dispatch_log.debug("fused_mapreduce dims=%s reduce=%s -> xla", dims, bool(red))
    return _xla_fused_mapreduce(f, op, initop, dims, out, ins, red)


def _squeeze_view(out: StridedView, red: Tuple[int, ...]) -> StridedView:
    """Output view with reduction dims collapsed to size 1 (stride already 0)."""
    shape = tuple(1 if i in red else d for i, d in enumerate(out.shape))
    return StridedView(out.parent, shape, out.strides, out.offset, out.conj)


def _xla_fused_mapreduce(f, op, initop, dims, out, ins, red) -> StridedView:
    in_arrs = [materialize(v) for v in ins]
    vals = f(*in_arrs) if in_arrs else f()
    vals = jnp.asarray(vals)
    if vals.shape != dims:
        vals = jnp.broadcast_to(vals, dims)

    out_read = _squeeze_view(out, red)
    if op is None:
        new_parent = scatter_into(out_read, vals.astype(out.dtype))
        return StridedView(new_parent, out.shape, out.strides, out.offset, out.conj)

    partial_ = _reduce_vals(op, vals, red) if red else vals
    # partial_ has kept dims only; reshape to out_read's (1-padded) shape.
    partial_ = partial_.reshape(out_read.shape)
    old = materialize(out_read)
    seed = initop(old) if initop is not None else old
    final = op(seed.astype(partial_.dtype), partial_)
    new_parent = scatter_into(out_read, final.astype(out.dtype))
    return StridedView(new_parent, out.shape, out.strides, out.offset, out.conj)


# ---------------------------------------------------------------------------
# user-facing façades (analog of /root/reference/src/mapreduce.jl:1-96)
# ---------------------------------------------------------------------------


def _check_same_shape(views):
    shapes = {tuple(v.shape) for v in views}
    if len(shapes) > 1:
        raise StridedLayoutError(f"shape mismatch across operands: {shapes}")


def map_into(out, f: Callable, *ins) -> StridedView:
    """``out .= f.(ins...)`` — analog of ``Base.map!``
    (`/root/reference/src/mapreduce.jl:38-53`). Shapes must match exactly.
    Inputs may be lazy :class:`StridedExpr` trees (leaves inlined: one
    fused kernel). Identity copies of a pattern-matching expression
    (``copy_into(out, v + v.T)``) route through the tile-pair kernel."""
    from .lazy_expr import flatten_operands, try_pattern_into
    from .broadcast import broadcast_views

    out = _as_view(out)
    hit = try_pattern_into(out, f, ins)
    if hit is not None:
        return hit
    # Shape check only over array-like operands: python/0-d scalars are
    # captured into the closure (CaptureArgs-style), not iterated.
    shapes = {tuple(out.shape)} | {
        tuple(v.shape) for v in ins if getattr(v, "ndim", 0) > 0
    }
    if len(shapes) > 1:
        raise StridedLayoutError(f"shape mismatch across operands: {shapes}")
    if out.size == 0:
        return out
    g, views = flatten_operands(f, ins)
    bviews = broadcast_views(out.shape, views)
    return fused_mapreduce(g, None, None, out.shape, out, bviews)


def smap(f: Callable, *ins) -> StridedView:
    """Allocating map with dtype promotion — analog of ``Base.map``
    (`/root/reference/src/mapreduce.jl:32-36`)."""
    from .lazy_expr import flatten_operands
    from .broadcast import broadcast_views

    shapes = {tuple(v.shape) for v in ins if getattr(v, "ndim", 0) > 0}
    if len(shapes) > 1:
        raise StridedLayoutError(f"shape mismatch across operands: {shapes}")
    shape = shapes.pop() if shapes else ()
    g, views = flatten_operands(f, ins)
    bviews = broadcast_views(shape, views)
    rdt = jax.eval_shape(g, *[jax.ShapeDtypeStruct((), v.dtype) for v in bviews]).dtype
    out = strided(jnp.zeros(shape, rdt))
    if math.prod(shape) == 0:
        return out
    return fused_mapreduce(g, None, None, shape, out, bviews)


def copy_into(out, src) -> StridedView:
    """``copy!(dst, src)`` = ``map!(identity, dst, src)``
    (`/root/reference/src/mapreduce.jl:2-4`)."""
    from .lazy_expr import identity_f

    return map_into(out, identity_f, src)


def permutedims_into(out, src, perm) -> StridedView:
    """Out-of-place permute as a lazy permute + fused strided copy — exactly
    the reference's trick (`/root/reference/src/mapreduce.jl:7-14`)."""
    from .view import permutedims as _p

    return copy_into(out, _p(_as_view(src), perm))


def adjoint_into(out, src) -> StridedView:
    """``adjoint!(dst, src)`` (`/root/reference/src/mapreduce.jl:7-10`)."""
    from .view import adjoint as _a

    return copy_into(out, _a(_as_view(src)))


def conj_into(out, src=None) -> StridedView:
    """``conj!(A)`` (`/root/reference/src/mapreduce.jl:5-6`)."""
    from .view import conj as _c

    src = out if src is None else src
    return copy_into(out, _c(_as_view(src)))


def sreduce(f: Callable, op: Callable, v, init=None):
    """Complete reduction ``mapreduce(f, op, A)`` — returns a 0-d array.

    Mirrors ``_mapreduce`` (`/root/reference/src/mapreduce.jl:55-72`): build a
    one-element output and reshape it (lazily) to an all-ones shape so every
    reduction dim has stride 0. ``v`` may be a lazy :class:`StridedExpr`:
    its leaves are inlined so map + reduce run as ONE fused pass."""
    from .broadcast import broadcast_views

    g, leaves, shape = as_expr_parts(v)
    total_f = lambda *arrs: f(g(*arrs))
    ndim = len(shape)
    size = math.prod(shape)
    if size == 0:
        if init is None:
            raise StridedLayoutError("reduction over empty view requires init")
        return jnp.asarray(init)
    bviews = broadcast_views(shape, leaves)
    scal = [jax.ShapeDtypeStruct((), b.dtype) for b in bviews]
    rdt = jax.eval_shape(total_f, *scal).dtype

    # Layout-invariance fast path: a complete reduction with a commutative
    # op over a single bijective view visits every parent element exactly
    # once, in SOME order — so reduce the flat parent directly and skip the
    # whole transpose/reshape recipe (the analog of the reference collapsing
    # a full reduction to one linear loop via dim fusion,
    # `/root/reference/src/mapreduce.jl:98-117`).
    from .regularize import is_full_bijection

    if (
        len(bviews) == 1
        and reduce_identity(op, rdt) is not None
        and is_full_bijection(bviews[0])
    ):
        leaf = bviews[0]
        arr = leaf.parent
        if leaf.conj:
            arr = jnp.conj(arr)
        from .regularize import decompose as _dec

        dphys = _dec(leaf.shape, leaf.strides, leaf.offset)
        # Reduce in the PHYSICAL shape (a free reshape of the parent), so
        # XLA sees a plain multi-dim reduction instead of a transpose.
        if dphys.sizes:
            arr = arr.reshape(dphys.sizes)
        partial_flat = _reduce_vals(op, total_f(arr), tuple(range(arr.ndim)))
        if init is not None:
            partial_flat = op(jnp.asarray(init, rdt), partial_flat)
        return partial_flat.astype(rdt)

    if init is None:
        ident = reduce_identity(op, rdt)
        initop = (lambda x: jnp.full_like(x, ident)) if ident is not None else None
        if ident is None:
            # Unknown identity: materialize (fused) and tree-fold in
            # log-depth — the reference errors here under threading
            # (`/root/reference/src/mapreduce.jl:188-191`).
            vals = total_f(*[materialize(b) for b in bviews])
            return _reduce_vals(op, jnp.broadcast_to(vals, shape), tuple(range(ndim)))
    else:
        initop = lambda x: jnp.full_like(x, jnp.asarray(init, rdt))
    out = strided(jnp.zeros((1,) * max(ndim, 1), rdt))
    out = StridedView(out.parent, shape, (0,) * ndim, 0, False)
    res = fused_mapreduce(total_f, op, initop, shape, out, bviews)
    return res.parent[0]


def sreduce_dims(f: Callable, op: Callable, v, axes, init=None) -> StridedView:
    """Partial reduction over ``axes`` — analog of ``Base.mapreducedim!``
    (`/root/reference/src/mapreduce.jl:25-30,74-84`). Returns a StridedView
    with the reduced dims kept at size 1. ``v`` may be a lazy
    :class:`StridedExpr` (fused map + partial reduce in one pass)."""
    from .broadcast import broadcast_views

    g, leaves, shape = as_expr_parts(v)
    total_f = lambda *arrs: f(g(*arrs))
    ndim = len(shape)
    if isinstance(axes, int):
        axes = (axes,)
    axes = tuple(sorted(range(ndim)[a] for a in axes))
    bviews = broadcast_views(shape, leaves)
    scal = [jax.ShapeDtypeStruct((), b.dtype) for b in bviews]
    rdt = jax.eval_shape(total_f, *scal).dtype
    out_shape = tuple(1 if i in axes else d for i, d in enumerate(shape))

    ident = reduce_identity(op, rdt)
    if init is not None:
        seed = jnp.asarray(init, rdt)
        initop = lambda x: jnp.full_like(x, seed)
    elif ident is not None:
        initop = lambda x: jnp.full_like(x, ident)
    else:
        raise StridedLayoutError(
            "partial reduction with unknown op identity requires init"
        )
    out = strided(jnp.zeros(out_shape, rdt))
    # Broadcast the output over the reduced dims: stride 0 there.
    out_b = broadcast_to(out, shape) if out_shape != shape else out
    res = fused_mapreduce(total_f, op, initop, shape, out_b, bviews)
    return StridedView(res.parent, out_shape, out.strides, 0, False)


def mapreducedim_into(f, op, initop, out, *ins) -> StridedView:
    """Raw engine entry with explicit ``initop`` — the contract tested by the
    reference at `/root/reference/test/othertests.jl:68-107` (all five initop
    shapes: identity/zero/scale/const/conj)."""
    out = _as_view(out)
    views = [_as_view(v) for v in ins]
    dims = views[0].shape if views else out.shape
    for v in views:
        if v.shape != dims:
            raise StridedLayoutError("input shape mismatch")
    if out.shape != dims:
        # out must broadcast over reduced dims
        out = broadcast_to(out, dims)
    return fused_mapreduce(f, op, initop, dims, out, views)


# ---------------------------------------------------------------------------
# convenience reductions — the Base-function surface (`sum(A)`, `sum(A;dims)`,
# `prod`, `maximum`, `minimum`, `mean` all work on StridedViews through the
# reference engine, `/root/reference/test/othertests.jl:109-128`); these are
# the same entry points with numpy-style axis arguments. All accept views OR
# lazy StridedExpr trees (fused map + reduce in one pass).
# ---------------------------------------------------------------------------


def _conv_reduce(op, v, axis, init=None):
    if axis is None:
        return sreduce(lambda x: x, op, v, init=init)
    return sreduce_dims(lambda x: x, op, v, axis, init=init)


def ssum(v, axis=None):
    """``sum(A)`` / ``sum(A; dims=axis)``."""
    return _conv_reduce(jnp.add, v, axis)


def sprod(v, axis=None):
    """``prod(A)`` / ``prod(A; dims=axis)``."""
    return _conv_reduce(jnp.multiply, v, axis)


def smax(v, axis=None):
    """``maximum(A)`` (NaN-propagating like Julia's ``max``)."""
    return _conv_reduce(jnp.maximum, v, axis)


def smin(v, axis=None):
    """``minimum(A)``."""
    return _conv_reduce(jnp.minimum, v, axis)


def smean(v, axis=None):
    """``mean(A)`` — ONE fused pass: the ``1/n`` scale folds into the map
    stage of the map+reduce kernel (``sum(x/n) == mean(x)``), so no second
    kernel touches the reduced output."""
    g, leaves, shape = as_expr_parts(v)
    if axis is None:
        n = math.prod(shape)
        return ssum(v) / n  # scalar epilogue: free under jit, still one pass
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(range(len(shape))[a] for a in axes)
    n = math.prod(shape[a] for a in axes)
    inv = 1.0 / n
    return sreduce_dims(lambda x: x * inv, jnp.add, v, axes)


__all__ += ["ssum", "sprod", "smax", "smin", "smean"]
