"""Lazy fused-broadcast expression trees — the ``Broadcasted`` analog.

In the reference, Julia's dot-syntax builds a ``Broadcasted`` tree that the
``copyto!`` overload flattens into ONE fused kernel over all strided leaves
(`/root/reference/src/broadcast.jl:27-98`): ``B .= (A .+ A') ./ 2`` touches
HBM exactly twice no matter how many operators appear. Eager pairwise
operators would instead materialize a dense intermediate per node — the very
temporaries the reference exists to eliminate (`/root/reference/README.md:101-105`).

:class:`StridedExpr` restores that contract on the device: Python operators on
:class:`StridedView` (and on expressions) return a lazy node that records the
elementwise function and its operand *leaves*; nested nodes are flattened at
construction (the ``CaptureArgs``/``consume`` walk of
`/root/reference/src/broadcast.jl:67-98`, done once per node instead of once
per call). Any consumption — ``materialize``/``np.asarray``, ``sbroadcast``
composition, a reduction, or a ``strided_jit`` return — collapses the whole
tree into a single ``fused_mapreduce`` over all leaves.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .view import StridedView, strided

__all__ = ["StridedExpr", "flatten_operands", "as_expr_parts"]


def flatten_operands(f: Callable, args: Sequence) -> Tuple[Callable, List[StridedView]]:
    """Flatten mixed (views / expressions / arrays / scalars) operands.

    Returns ``(g, leaves)`` where ``leaves`` are :class:`StridedView`s and
    ``g(*dense_leaf_values)`` evaluates ``f`` with scalars embedded and child
    expressions recursively applied — one composed elementwise closure for
    the entire tree."""
    leaves: List[StridedView] = []
    getters = []
    for a in args:
        if isinstance(a, StridedExpr):
            start = len(leaves)
            leaves.extend(a.leaves)
            getters.append(
                lambda vals, s=start, n=len(a.leaves), cf=a.f: cf(*vals[s : s + n])
            )
        elif isinstance(a, StridedView):
            idx = len(leaves)
            leaves.append(a)
            getters.append(lambda vals, i=idx: vals[i])
        elif isinstance(a, (jax.Array, np.ndarray)) and getattr(a, "ndim", 0) > 0:
            idx = len(leaves)
            leaves.append(strided(jnp.asarray(a)))
            getters.append(lambda vals, i=idx: vals[i])
        else:  # python / 0-d scalar: embed in the closure (CaptureArgs-style)
            getters.append(lambda vals, a=a: a)

    def g(*vals):
        return f(*[get(vals) for get in getters])

    return g, leaves


def as_expr_parts(x) -> Tuple[Callable, List[StridedView], Tuple[int, ...]]:
    """``(f, leaves, shape)`` for a view or expression — the uniform input
    contract for fusing consumers (reductions, in-place assignment)."""
    if isinstance(x, StridedExpr):
        return x.f, list(x.leaves), x.shape
    v = x if isinstance(x, StridedView) else strided(jnp.asarray(x))
    return (lambda a: a), [v], v.shape


class StridedExpr:
    """A lazy elementwise expression over strided-view leaves.

    ``f`` consumes one dense array per leaf (already broadcast to ``shape``)
    and returns the elementwise result. Construction flattens child
    expressions so the tree is always exactly one level deep."""

    __slots__ = ("f", "leaves", "shape", "raw_op", "raw_args")

    def __init__(self, f: Callable, args: Sequence):
        g, leaves = flatten_operands(f, args)
        if not leaves:
            raise ValueError("StridedExpr requires at least one array operand")
        self.f = g
        self.leaves = tuple(leaves)
        self.shape = tuple(jnp.broadcast_shapes(*[v.shape for v in leaves]))
        # Structure retained for pattern dispatch (the closure above erases
        # it): the node's own op and its un-flattened operands. The analog of
        # the reference dispatching `B .= (A .+ A')./2` to a specialized
        # path by looking at the Broadcasted tree, not the fused closure.
        self.raw_op = f
        self.raw_args = tuple(args)

    # -- introspection -----------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def dtype(self):
        out = jax.eval_shape(
            self.f, *[jax.ShapeDtypeStruct((), v.dtype) for v in self.leaves]
        )
        return out.dtype

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"StridedExpr(shape={self.shape}, nleaves={len(self.leaves)}, "
            f"dtype={self.dtype})"
        )

    # -- consumption -------------------------------------------------------
    def evaluate(self) -> StridedView:
        """Collapse into one fused kernel; returns a dense StridedView.

        Structured patterns are recognized first — the transpose-pair family
        ``alpha*A + beta*C.T`` in all its spellings — and each sub-family
        goes to its own path:

        - same-buffer pairs (``(v + v.T)/2``, ``v - v.T``, ``3*v + 2*v.T``,
          `/root/reference/src/linalg.jl:39-42`) at or above
          ``Config.pair_kernel_min_elements`` → the tile-pair kernel (one
          read and one write per element instead of two reads and a write);
        - distinct-buffer pairs (``v + w.T``) → the fused XLA expression
          (both buffers must be read anyway; the pair schedule saves no
          bytes);
        - single transposed terms (``3 * v.T``) → generic/XLA (XLA's
          transpose emitter; the pair schedule saves no bytes).

        Everything else takes the generic fused path."""
        from .broadcast import sbroadcast

        res = try_pattern_expr(self)
        if res is not None:
            return res
        global LAST_EXPR_DISPATCH
        LAST_EXPR_DISPATCH = "generic"
        return sbroadcast(self.f, *self.leaves)

    def materialize(self) -> jax.Array:
        from .regularize import materialize

        return materialize(self.evaluate())

    def __array__(self, dtype=None):
        return np.asarray(self.materialize(), dtype=dtype)

    # -- reductions fuse through the tree (installed by
    # ``_install_reductions`` below, shared with StridedView: the reference's
    # mapreduce works over any op on lazy views,
    # `/root/reference/test/othertests.jl:109-128`) --------------------------


# Observability for tests/benchmarks: which path the last evaluate() took —
# "pair-kernel" (same-buffer two-term family through the tile-pair kernel),
# "xla-pair" (distinct-buffer pair through the jitted fused-XLA
# expression), or "generic" (the fused engine). Recorded at trace time: on a
# jit cache hit nothing re-traces. Only set to "pair-kernel" AFTER the
# shared eligibility predicate (kernels_special.pair_kernel_tile) has
# confirmed the kernel will actually run.
LAST_EXPR_DISPATCH: str = ""


def identity_f(x):
    """Marker identity used by ``copy_into``/``.at[...].set`` so the façades
    can recognize a pure copy of a lazy expression and route it through the
    structured pattern dispatch — the in-place analog of the reference's
    ``B .= (A .+ A')./2`` hitting the same engine as the allocating spelling
    (`/root/reference/src/broadcast.jl:24,27-37`)."""
    return x


def _python_scalar(x):
    """A compile-time scalar the pattern dispatch may bake statically: plain
    Python/numpy numbers only — tracers and 0-d arrays stay dynamic and
    disqualify the pattern (the generic path handles them)."""
    import numbers

    if isinstance(x, bool) or not isinstance(x, numbers.Real):
        return None
    return float(x)


def _square_parent(v, n):
    """The parent as an (n, n) array when ``v`` covers it fully, else None."""
    if v.conj or v.ndim != 2 or v.shape != (n, n) or n == 0 or v.offset != 0:
        return None
    if int(v.parent.shape[0]) != n * n:
        return None
    return v.parent.reshape(n, n)


def _linear_term(x):
    """Parse one addend of the pair pattern: a bare view, ``scalar * view``
    (either order), or ``-view``. Returns ``(coeff, view)`` or None."""
    if isinstance(x, StridedView):
        return 1.0, x
    if isinstance(x, StridedExpr) and len(x.raw_args) == 2 and x.raw_op is jnp.multiply:
        for s, e in (x.raw_args, x.raw_args[::-1]):
            sc = _python_scalar(s)
            if sc is not None and isinstance(e, StridedView):
                return sc, e
    if (
        isinstance(x, StridedExpr)
        and x.raw_op is jnp.negative
        and len(x.raw_args) == 1
        and isinstance(x.raw_args[0], StridedView)
    ):
        return -1.0, x.raw_args[0]
    return None


def _match_pair(expr: "StridedExpr"):
    """Recognize the transpose-pair family over the raw (un-flattened) tree:

        epilogue( c1*X (+|-) c2*Y )      — the two-term family, or
        epilogue( c2*Y )                 — the single-transposed-term family
                                           (``B .= 3 .* A'``, the reference's
                                           README row 2 / ``mul!(B, 3, A')``,
                                           `/root/reference/src/linalg.jl:22-31`)

    where (two-term) exactly one of {X, Y} is a plain row-major square view
    and the other the lazy transpose of a (possibly different) square
    buffer, or (single-term) Y is a lazy-transposed square view; the
    epilogue is nothing, ``* scalar``, or ``/ scalar``. Returns
    ``(A2d, C2d_or_None, alpha, beta, scale_mode, scale)`` — ``C2d`` None
    means both terms view the SAME buffer (``v`` and ``v.T``; matched by
    object identity, see the eager-use caveat in ``try_pattern_expr``), and
    ``alpha == 0.0`` marks the single-term case (the kernel skips the plain
    term entirely, keeping kernel/generic bit-exactness) —
    or None when the tree doesn't match."""
    scale_mode, scale = None, 1.0
    inner = expr
    op = expr.raw_op
    args = expr.raw_args
    if op is jnp.multiply and len(args) == 2:
        for s, e in (args, args[::-1]):
            sc = _python_scalar(s)
            if sc is not None and isinstance(e, StridedExpr):
                scale_mode, scale, inner = "mul", sc, e
                break
        else:
            # not scalar*subexpr: could still be the single-term family
            # ``scalar * view.T`` (the multiply node itself is the term)
            return _match_single_transposed(expr, None, 1.0)
    elif op is jnp.true_divide and len(args) == 2:
        sc = _python_scalar(args[1])
        if sc in (None, 0.0) or not isinstance(args[0], StridedExpr):
            return None
        scale_mode, scale, inner = "div", sc, args[0]

    if not isinstance(inner, StridedExpr) or len(inner.raw_args) != 2:
        return _match_single_transposed(inner, scale_mode, scale)
    if inner.raw_op is jnp.add:
        sign2 = 1.0
    elif inner.raw_op is jnp.subtract:
        sign2 = -1.0
    else:
        return _match_single_transposed(inner, scale_mode, scale)
    return _match_two_terms(inner, sign2, scale_mode, scale)


def _match_single_transposed(x, scale_mode, scale):
    """Single-term arm of :func:`_match_pair`: ``epilogue(c * view.T)``.
    Only a lazy-TRANSPOSED (column-major) square view qualifies — a plain
    scaled copy is a streaming op XLA already handles at stream rate; the
    pair kernel's value is replacing transposed HBM reads."""
    t = _linear_term(x)
    if t is None:
        return None
    c, v = t
    n = v.shape[0] if v.ndim == 2 else 0
    p = _square_parent(v, n)
    if p is None or n < 2 or v.strides != (1, n):
        return None
    return p, None, 0.0, c, scale_mode, scale, True


def _match_two_terms(inner, sign2, scale_mode, scale):
    t1 = _linear_term(inner.raw_args[0])
    t2 = _linear_term(inner.raw_args[1])
    if t1 is None or t2 is None:
        return None
    (c1, v1), (c2, v2) = t1, t2
    c2 *= sign2

    n = v1.shape[0] if v1.ndim == 2 else 0
    row_major, col_major = (n, 1), (1, n)
    terms = []
    for c, v in ((c1, v1), (c2, v2)):
        p = _square_parent(v, n)
        if p is None or v.strides not in (row_major, col_major):
            return None
        terms.append((c, p, v.strides == col_major))
    (ca, pa, ta), (cb, pb, tb) = terms
    if ta == tb:
        return None  # need exactly one plain + one transposed operand
    same = v1.parent is v2.parent
    if tb:  # second term is the transposed one: (alpha, A) = plain term
        alpha, A, beta, C = ca, pa, cb, pb
    else:
        alpha, A, beta, C = cb, pb, ca, pa
    # plain_first records the SOURCE term order (plain term first?) so the
    # kernel adds in the same order as the generic closure — XLA's FMA
    # contraction is order-sensitive in the last ulp (see _pair_term).
    return A, (None if same else C), alpha, beta, scale_mode, scale, tb


def try_pattern_expr(expr: "StridedExpr"):
    """Dispatch ``expr`` to the tile-pair kernel when it matches the
    transpose-pair family AND the kernel's own eligibility predicate
    confirms it will run (never claims the kernel while it would silently
    fall back). Returns a dense StridedView or None.

    Caveat (eager use): the same-buffer match compares ``a.parent is
    b.parent`` — two separate ``strided(x)`` wraps of one array are
    *different* parent objects, so ``strided(x) + strided(x).T`` misses the
    2-pass kernel (it still matches as a DISTINCT-buffer pair, reading the
    buffer twice). Under ``strided_jit`` the argument is wrapped once, so
    the fast form always matches; pinned by
    ``tests/test_lazy_expr.py::test_pair_pattern_eager_double_wrap``."""
    from ..config import get_config

    cfg = get_config()
    if not cfg.expr_pattern_dispatch:
        return None
    m = _match_pair(expr)
    if m is None:
        return None
    A, C, alpha, beta, scale_mode, scale, plain_first = m
    if alpha == 0.0:
        # Single-transposed-term family (``3 .* A'``): one read and one write
        # per element either way, so the pair schedule saves nothing and
        # the family stays on the generic path (XLA's transpose emitter).
        # The kernel retains alpha==0 support for direct pair_axpby calls.
        return None
    if str(A.dtype) not in ("float32", "bfloat16"):
        return None
    if C is not None and C.dtype != A.dtype:
        return None  # mixed dtypes promote in the generic path; kernel can't

    from .kernels_special import pair_kernel_tile, pair_axpby, pair_fallback_call

    global LAST_EXPR_DISPATCH
    if C is not None:
        # Distinct-buffer pairs (A + B.T): both buffers are read once and
        # the output written once by the fused expression too, so the pair
        # schedule saves no bytes. Route to the identical-structure fused
        # XLA expression directly.
        LAST_EXPR_DISPATCH = "xla-pair"
        import logging

        logging.getLogger("strided_tpu.dispatch").debug(
            "evaluate: %g*A + %g*C.T (distinct buffers) -> fused XLA",
            alpha, beta,
        )
        return strided(
            pair_fallback_call(
                A, C, alpha=alpha, beta=beta, scale_mode=scale_mode,
                scale=scale, plain_first=plain_first,
            )
        )

    n = A.shape[0]
    tile = pair_kernel_tile(n, n, A.dtype)
    if tile is None:
        return None

    LAST_EXPR_DISPATCH = "pair-kernel"
    import logging

    logging.getLogger("strided_tpu.dispatch").debug(
        "evaluate: %g*A + %g*A.T (%s %g) -> tile-pair kernel (n=%d, tile=%d)",
        alpha, beta,
        scale_mode, scale, n, tile,
    )
    return strided(
        pair_axpby(
            A, C, alpha=alpha, beta=beta,
            scale_mode=scale_mode, scale=scale, tile=tile,
            plain_first=plain_first,
        )
    )


def try_pattern_into(out: StridedView, f, ins):
    """In-place route into the pair kernel: ``map_into(out, identity, expr)``
    / ``copy_into(out, expr)`` / ``v.at[:].set(expr)`` hit the same kernel
    as the allocating spelling when ``out`` is a full dense row-major view
    of its parent (the kernel's fresh buffer then simply REPLACES the
    parent — a free functional update). Returns the updated view or None."""
    if f is not identity_f or len(ins) != 1 or not isinstance(ins[0], StridedExpr):
        return None
    expr = ins[0]
    if tuple(expr.shape) != tuple(out.shape) or out.conj or out.offset != 0:
        return None
    from .view import row_major_strides

    if out.strides != row_major_strides(out.shape):
        return None
    if int(out.parent.shape[0]) != out.size:
        return None
    if expr.dtype != out.dtype:
        # checked BEFORE dispatching: running the kernel and then discarding
        # its result would waste a full pass AND leave LAST_EXPR_DISPATCH
        # claiming a path that didn't produce the output
        return None
    res = try_pattern_expr(expr)
    if res is None:
        return None
    return StridedView(res.parent, out.shape, out.strides, 0, False)


def _expr_binop(f):
    def fwd(self, other):
        return StridedExpr(f, (self, other))

    def rev(self, other):
        return StridedExpr(f, (other, self))

    return fwd, rev


def _install_operators(cls):
    """Install lazy operator overloads on ``cls`` (StridedView and
    StridedExpr share the exact same operator surface)."""
    for name, fn in [
        ("add", jnp.add),
        ("sub", jnp.subtract),
        ("mul", jnp.multiply),
        ("truediv", jnp.true_divide),
        ("pow", jnp.power),
        ("mod", jnp.mod),
    ]:
        fwd, rev = _expr_binop(fn)
        setattr(cls, f"__{name}__", fwd)
        setattr(cls, f"__r{name}__", rev)
    for name, fn in [
        ("lt", jnp.less),
        ("le", jnp.less_equal),
        ("gt", jnp.greater),
        ("ge", jnp.greater_equal),
    ]:
        setattr(cls, f"__{name}__", _expr_binop(fn)[0])
    cls.__neg__ = lambda self: StridedExpr(jnp.negative, (self,))
    cls.__abs__ = lambda self: StridedExpr(jnp.abs, (self,))
    # Opt OUT of numpy's ufunc protocol: without this, `np.float64(3) * v`
    # dispatches to np.multiply, which silently MATERIALIZES the view
    # host-side through __array__ (a full device->host fetch) instead of
    # building a lazy expression. None makes numpy return NotImplemented so
    # Python falls back to our __rmul__. Explicit
    # np.asarray(view) still works through __array__.
    cls.__array_ufunc__ = None


def _install_reductions(cls):
    """Install the fused-reduction method surface (``.sum/.prod/.max/.min/
    .mean``) and ``@`` on ``cls`` — StridedView and StridedExpr share it
    each collapsing through the existing fused
    reducers in ONE map+reduce pass."""

    def _method(name, reducer_name):
        def method(self, axis=None):
            from . import mapreduce

            return getattr(mapreduce, reducer_name)(self, axis)

        method.__name__ = name
        method.__doc__ = (
            f"Fused ``{reducer_name}`` over this lazy view/expression "
            f"(one map+reduce pass; see ``core.mapreduce.{reducer_name}``)."
        )
        return method

    for name, reducer in [
        ("sum", "ssum"),
        ("prod", "sprod"),
        ("max", "smax"),
        ("min", "smin"),
        ("mean", "smean"),
    ]:
        setattr(cls, name, _method(name, reducer))

    def __matmul__(self, other):
        from ..linalg import matmul

        return matmul(self, other)

    def __rmatmul__(self, other):
        from ..linalg import matmul

        return matmul(other, self)

    cls.__matmul__ = __matmul__
    cls.__rmatmul__ = __rmatmul__


_install_operators(StridedExpr)
_install_reductions(StridedExpr)
