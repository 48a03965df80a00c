"""Lazy strided views over flat JAX buffers — the L0 view algebra.

XLA-native analog of ``StridedView`` from StridedViews.jl as consumed by the
reference (imported at `/root/reference/src/Strided.jl:12-16`; field layout
``(parent, size, strides, offset, op)`` evidenced at
`/root/reference/src/broadcast.jl:64` and `/root/reference/src/linalg.jl:50`).

A :class:`StridedView` is a pytree whose single array leaf is a *flat* 1-D
buffer living in HBM; ``shape``/``strides``/``offset``/``conj`` are static
(hashable) metadata. Every layout transform — ``permutedims``, ``transpose``,
``adjoint``, ``conj``, ``sreshape``, ``sview`` (slicing), ``flip``,
``broadcast_to`` — is an O(1) metadata edit, never data movement, mirroring
the reference's lazy semantics (`/root/reference/README.md:160-177`).

Differences from the reference, by design (XLA-first):

- Row-major (C) convention, matching numpy/JAX, instead of Julia column-major.
  Strides are in **elements**, not bytes.
- ``conj`` is a boolean flag rather than a function (the reference restricts
  ``op`` to ``identity``/``conj`` anyway, `/root/reference/src/linalg.jl:50`).
- Materialization is deferred to the executors (see ``regularize.py``): XLA
  has no pointer arithmetic, so a view is *lowered* to a
  slice/reshape/transpose/broadcast/rev recipe that XLA fuses into consumers.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from functools import reduce
from typing import Any, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "StridedView",
    "StridedLayoutError",
    "strided",
    "as_view",
    "isstrided",
    "row_major_strides",
    "permutedims",
    "transpose",
    "adjoint",
    "conj",
    "sreshape",
    "sview",
    "set_view",
    "flip",
    "broadcast_to",
]


class StridedLayoutError(ValueError):
    """Raised when a requested view cannot preserve stridedness.

    Mirrors the reference's error on non-stride-preserving ``sreshape``
    (`/root/reference/README.md:186-190`)."""


def _prod(xs) -> int:
    return reduce(operator.mul, xs, 1)


def row_major_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """C-order strides (in elements) for a dense array of ``shape``."""
    strides = []
    acc = 1
    for d in reversed(tuple(shape)):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True, eq=False)
class StridedView:
    """A lazy strided window into a flat 1-D buffer.

    ``parent`` is the flat HBM buffer (the only pytree leaf). Logical element
    ``(i_0, ..., i_{n-1})`` lives at flat index
    ``offset + sum_k i_k * strides[k]``; if ``conj`` is set, reads apply
    complex conjugation (and writes apply it inversely), matching the
    reference's ``ParentIndex`` read/write semantics
    (`/root/reference/src/mapreduce.jl:276-278`).
    """

    parent: jax.Array
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]
    offset: int
    conj: bool = False

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.parent,), (self.shape, self.strides, self.offset, self.conj)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(leaves[0], *aux)

    # -- basic properties --------------------------------------------------
    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return _prod(self.shape)

    def __post_init__(self):
        if len(self.shape) != len(self.strides):
            raise StridedLayoutError(
                f"shape {self.shape} and strides {self.strides} rank mismatch"
            )

    # -- lazy transforms (all O(1) metadata) -------------------------------
    def permute(self, perm: Sequence[int]) -> "StridedView":
        return permutedims(self, perm)

    @property
    def T(self) -> "StridedView":
        return transpose(self)

    @property
    def H(self) -> "StridedView":
        return adjoint(self)

    def reshape(self, *shape) -> "StridedView":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return sreshape(self, shape)

    def __getitem__(self, idx) -> "StridedView":
        return sview(self, idx)

    @property
    def at(self) -> "_At":
        """Functional in-place indexed assignment — the ``dotview`` analog.

        The reference lets ``B[rng] .= expr`` hit the lazy view so the
        broadcast fuses straight into the parent storage
        (`/root/reference/src/broadcast.jl:24`); here
        ``v.at[idx].set(expr)`` lowers to ``sbroadcast_into(sview(v, idx),
        ...)`` and returns the WHOLE view with its functionally-updated
        parent. ``expr`` may be a scalar, array, view, or lazy
        :class:`~strided_tpu.core.lazy_expr.StridedExpr` (one fused kernel).
        Also available: ``.add``, ``.mul``, ``.apply(f, *args)``."""
        return _At(self)

    # -- materialization (delegates to regularize to avoid an import cycle)
    def materialize(self) -> jax.Array:
        from . import regularize

        return regularize.materialize(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"StridedView(shape={self.shape}, strides={self.strides}, "
            f"offset={self.offset}, conj={self.conj}, dtype={self.dtype})"
        )


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def strided(x: Union[jax.Array, StridedView, Any]) -> StridedView:
    """Wrap an array as a :class:`StridedView`.

    Analog of the reference's ``StridedView(::DenseArray)`` constructor and
    of ``maybestrided`` (`/root/reference/src/macros.jl:31-34`). Dense (C-
    contiguous) inputs wrap with row-major strides; **non-contiguous numpy
    arrays are ADOPTED**, not densified: the layout ``(shape, strides,
    offset)`` is re-derived from the numpy ``.strides``/data pointer over
    the owning base buffer — the analog of the reference constructor
    re-deriving strided layouts from ``SubArray``/``ReshapedArray`` parents
    (`/root/reference/README.md:237-250`) — so ``np.lib.stride_tricks``
    windows, transposes, and negative-step slices keep their lazy layout.
    Non-element-aligned layouts raise :class:`StridedLayoutError`, like the
    reference's error on non-strided-expressible parents (its
    ``ReinterpretArray`` case). Note the whole base buffer is transferred
    to HBM once (device memory is flat; the view stays metadata) — unless
    the base is both > 4 MB and > 4x larger than the view, in which case
    the window is densified host-side instead of uploading the whole base."""
    if isinstance(x, StridedView):
        return x
    if isinstance(x, np.ndarray) and not x.flags.c_contiguous and x.size > 0:
        return _adopt_numpy(x)
    x = jnp.asarray(x)
    return StridedView(
        parent=x.reshape(-1),
        shape=tuple(x.shape),
        strides=row_major_strides(x.shape),
        offset=0,
        conj=False,
    )


def _adopt_layout(x: "np.ndarray"):
    """Validate and derive ``(strides_el, root, offset)`` for adopting a
    non-contiguous numpy array — the SINGLE point of truth consulted by both
    :func:`strided` (which then transfers the root) and :func:`isstrided`
    (layout-only, no transfer). Raises :class:`StridedLayoutError` on any
    layout :func:`strided` could not adopt."""
    itemsize = x.itemsize
    if any(s % itemsize for s in x.strides):
        raise StridedLayoutError(
            f"cannot adopt numpy layout: byte strides {x.strides} are not "
            f"multiples of the {itemsize}-byte element size"
        )
    strides_el = tuple(s // itemsize for s in x.strides)
    root = _numpy_root(x)
    if root.dtype.itemsize != itemsize or root.dtype != x.dtype:
        raise StridedLayoutError(
            f"cannot adopt numpy view of dtype {x.dtype} over a base of "
            f"dtype {root.dtype} (reinterpreted layouts are not strided)"
        )
    if not (root.flags.c_contiguous or root.flags.f_contiguous):
        raise StridedLayoutError(
            "cannot adopt numpy view: owning base buffer is not contiguous"
        )
    off_bytes = x.__array_interface__["data"][0] - root.__array_interface__["data"][0]
    if off_bytes % itemsize:
        raise StridedLayoutError(
            "cannot adopt numpy view: data offset is not element-aligned"
        )
    offset = off_bytes // itemsize
    lo = offset + sum(min(0, (d - 1) * s) for d, s in zip(x.shape, strides_el))
    hi = offset + sum(max(0, (d - 1) * s) for d, s in zip(x.shape, strides_el))
    if lo < 0 or hi >= root.size:
        raise StridedLayoutError(
            f"adopted view spans [{lo}, {hi}] outside base of {root.size} elements"
        )
    return strides_el, root, offset


# Adoption transfers the ENTIRE owning base buffer to device (the view is
# metadata over it). For a small window over a huge base (stride_tricks
# windows) that transfer moves mostly bytes the view never reads, so when
# the base is both LARGE in absolute terms and > 4x the view footprint we
# densify the window instead: one small host-side copy replaces a large
# transfer, and downstream semantics are identical (the parent is a fresh
# device buffer either way; ``isstrided`` remains layout-only). Small bases
# always adopt — the transfer is trivial and the lazy layout is the
# contract the view tests pin.
_ADOPT_MAX_BASE_RATIO = 4
_ADOPT_DENSIFY_MIN_BASE_BYTES = 4 << 20


def _adopt_numpy(x: "np.ndarray") -> StridedView:
    """Derive (shape, strides, offset) from a non-contiguous numpy array's
    byte strides over its owning base buffer (see :func:`strided`)."""
    strides_el, root, offset = _adopt_layout(x)
    if (
        root.nbytes > _ADOPT_DENSIFY_MIN_BASE_BYTES
        and root.size > _ADOPT_MAX_BASE_RATIO * max(x.size, 1)
    ):
        dense = np.ascontiguousarray(x)
        return StridedView(
            parent=jnp.asarray(dense).reshape(-1),
            shape=tuple(x.shape),
            strides=row_major_strides(x.shape),
            offset=0,
            conj=False,
        )
    flat = (
        root.reshape(-1)
        if root.flags.c_contiguous
        else root.reshape(-1, order="F")  # memory-order view, no copy
    )
    return StridedView(
        parent=jnp.asarray(flat),
        shape=tuple(x.shape),
        strides=strides_el,
        offset=offset,
        conj=False,
    )


def isstrided(x) -> bool:
    """Can ``x`` be expressed as a strided view without a copy? — the
    reference's ``isstrided`` predicate (StridedViews.jl, re-exported at
    `/root/reference/src/Strided.jl:12-16`). True for views, jax arrays,
    and numpy arrays whose layout :func:`strided` can adopt."""
    if isinstance(x, (StridedView, jax.Array)):
        return True
    if isinstance(x, np.ndarray):
        if x.flags.c_contiguous or x.size == 0:
            return True
        try:
            _adopt_layout(x)  # the exact validation strided() performs
            return True
        except StridedLayoutError:
            return False
    return False


def _numpy_root(x: "np.ndarray") -> "np.ndarray":
    """Deepest ndarray in the ``.base`` chain (walking through non-ndarray
    links like ``np.lib.stride_tricks``' DummyArray)."""
    node, root = x, x
    while True:
        b = getattr(node, "base", None)
        if b is None:
            break
        node = b
        if isinstance(b, np.ndarray):
            root = b
    return root




as_view = strided


# ---------------------------------------------------------------------------
# lazy layout transforms
# ---------------------------------------------------------------------------


def permutedims(v: StridedView, perm: Sequence[int]) -> StridedView:
    """Lazy dimension permutation — metadata only.

    Analog of lazy ``permutedims`` on StridedViews
    (`/root/reference/README.md:165-170`)."""
    perm = tuple(int(p) for p in perm)
    if sorted(perm) != list(range(v.ndim)):
        raise StridedLayoutError(f"invalid permutation {perm} for rank {v.ndim}")
    return StridedView(
        v.parent,
        tuple(v.shape[p] for p in perm),
        tuple(v.strides[p] for p in perm),
        v.offset,
        v.conj,
    )


def transpose(v: StridedView) -> StridedView:
    """Full-rank reversal (2-D: matrix transpose), lazy."""
    return permutedims(v, tuple(reversed(range(v.ndim))))


def conj(v: StridedView) -> StridedView:
    """Lazy elementwise conjugation (toggles the ``conj`` flag).

    No-op flag for real dtypes is kept anyway so layout algebra stays uniform
    (the reference does the same: ``conj`` on real views is ``identity``)."""
    if not jnp.issubdtype(v.dtype, jnp.complexfloating):
        return v
    return StridedView(v.parent, v.shape, v.strides, v.offset, not v.conj)


def adjoint(v: StridedView) -> StridedView:
    """Lazy conjugate-transpose (``A'`` in the reference)."""
    return conj(transpose(v))


def flip(v: StridedView, axis: int) -> StridedView:
    """Lazy reversal along ``axis`` via a negative stride."""
    axis = range(v.ndim)[axis]
    d = v.shape[axis]
    s = v.strides[axis]
    new_offset = v.offset + (d - 1) * s
    new_strides = list(v.strides)
    new_strides[axis] = -s
    return StridedView(v.parent, v.shape, tuple(new_strides), new_offset, v.conj)


def broadcast_to(v: StridedView, shape: Sequence[int]) -> StridedView:
    """Lazy broadcast: size-1 (or missing leading) dims become stride-0 dims.

    This is the same trick the reference's broadcast front-end uses
    (``promoteshape`` assigns stride 0 to broadcast dims,
    `/root/reference/src/broadcast.jl:50-65`)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) < v.ndim:
        raise StridedLayoutError(f"cannot broadcast rank {v.ndim} to shape {shape}")
    lead = len(shape) - v.ndim
    new_strides = [0] * lead
    for k in range(v.ndim):
        if v.shape[k] == shape[lead + k]:
            new_strides.append(v.strides[k])
        elif v.shape[k] == 1:
            new_strides.append(0)
        else:
            raise StridedLayoutError(
                f"cannot broadcast shape {v.shape} to {shape}"
            )
    return StridedView(v.parent, shape, tuple(new_strides), v.offset, v.conj)


def sreshape(v: StridedView, shape: Sequence[int]) -> StridedView:
    """Stride-preserving lazy reshape; raises :class:`StridedLayoutError` if
    the new shape cannot be expressed over the existing strides without a
    copy — the same contract as the reference's ``sreshape``
    (`/root/reference/README.md:186-190`).

    Implementation: greedily merge the old dims into maximal contiguous
    chunks (row-major adjacency ``s[i] == s[i+1] * d[i+1]``), then factor the
    new shape across those chunks in order. Size-1 dims are free on both
    sides (they get the stride that keeps the result canonical)."""
    shape = tuple(int(s) for s in shape)
    if _prod(shape) != v.size:
        raise StridedLayoutError(
            f"cannot reshape view of size {v.size} (shape {v.shape}) to {shape}"
        )
    if v.size == 0:
        # Degenerate: any strides will do; use row-major of the new shape.
        return StridedView(v.parent, shape, row_major_strides(shape), v.offset, v.conj)

    # Drop size-1 dims from the old shape (they carry no layout information).
    old = [(d, s) for d, s in zip(v.shape, v.strides) if d != 1]

    # Merge into maximal contiguous chunks: each chunk is (total_size,
    # innermost_stride) and within the chunk layout is dense row-major.
    chunks = []  # list of (size, inner_stride)
    for d, s in old:
        if chunks and chunks[-1][1] == s * d:
            chunks[-1] = (chunks[-1][0] * d, s)
        else:
            chunks.append((d, s))
    if not chunks:
        chunks = [(1, 1)]

    # Factor the new shape across chunks, in order.
    new_strides = []
    ci = 0
    remaining, inner = chunks[0]
    for d in shape:
        if d == 1:
            # Stride chosen for canonical nesting; value is irrelevant.
            new_strides.append(remaining * inner if remaining else 1)
            continue
        while remaining == 1 and ci + 1 < len(chunks):
            ci += 1
            remaining, inner = chunks[ci]
        if remaining % d != 0:
            raise StridedLayoutError(
                f"cannot sreshape {v.shape} with strides {v.strides} to {shape} "
                "without a copy"
            )
        remaining //= d
        new_strides.append(remaining * inner)
    if remaining != 1 or ci + 1 < len(chunks):
        raise StridedLayoutError(
            f"cannot sreshape {v.shape} with strides {v.strides} to {shape} "
            "without a copy"
        )
    return StridedView(v.parent, shape, tuple(new_strides), v.offset, v.conj)


class _At:
    """Indexer for :attr:`StridedView.at` (see its docstring)."""

    __slots__ = ("_view",)

    def __init__(self, view: StridedView):
        self._view = view

    def __getitem__(self, idx) -> "_IndexUpdate":
        return _IndexUpdate(self._view, idx)


class _IndexUpdate:
    __slots__ = ("_view", "_idx")

    def __init__(self, view: StridedView, idx):
        self._view = view
        self._idx = idx

    def _finish(self, sub_updated: StridedView) -> StridedView:
        v = self._view
        return StridedView(sub_updated.parent, v.shape, v.strides, v.offset, v.conj)

    def apply(self, f, *args) -> StridedView:
        """``v[idx] .= f.(args...)`` — fused broadcast into the sub-view;
        returns the whole updated view."""
        from .broadcast import sbroadcast_into

        sub = sview(self._view, self._idx)
        return self._finish(sbroadcast_into(sub, f, *args))

    def set(self, value) -> StridedView:
        """``v[idx] .= value`` (scalar / array / view / lazy expr). Pattern-
        matching expressions route through the tile-pair kernel when the
        indexed sub-view is a full dense window (e.g. ``v.at[:].set(...)``)."""
        from .lazy_expr import identity_f

        return self.apply(identity_f, value)

    def add(self, value) -> StridedView:
        """``v[idx] .+= value``."""
        from .broadcast import sbroadcast_into

        sub = sview(self._view, self._idx)
        return self._finish(sbroadcast_into(sub, lambda a, b: a + b, sub, value))

    def mul(self, value) -> StridedView:
        """``v[idx] .*= value``."""
        from .broadcast import sbroadcast_into

        sub = sview(self._view, self._idx)
        return self._finish(sbroadcast_into(sub, lambda a, b: a * b, sub, value))


def set_view(v: StridedView, idx, value) -> StridedView:
    """Functional ``v[idx] .= value`` — module-level spelling of
    ``v.at[idx].set(value)`` (`/root/reference/src/broadcast.jl:24` analog)."""
    return _At(v)[idx].set(value)


def sview(v: StridedView, idx) -> StridedView:
    """Lazy basic indexing: ints (drop the dim), slices (start/stop/step, any
    sign), ``...``, ``None`` (newaxis, stride-0 size-1 dim). Analog of the
    reference's range-``getindex``/``sview`` (`/root/reference/README.md:190-192`),
    generalized to negative steps (which the reference reaches through reverse
    ranges)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    # Expand Ellipsis.
    n_specified = sum(1 for i in idx if i is not None and i is not Ellipsis)
    if Ellipsis in idx:
        e = idx.index(Ellipsis)
        fill = (slice(None),) * (v.ndim - n_specified)
        idx = idx[:e] + fill + idx[e + 1 :]
        if Ellipsis in idx:
            raise StridedLayoutError("only one Ellipsis allowed")
    else:
        idx = idx + (slice(None),) * (v.ndim - n_specified)

    new_shape = []
    new_strides = []
    offset = v.offset
    axis = 0
    for i in idx:
        if i is None:
            new_shape.append(1)
            new_strides.append(0)
            continue
        if axis >= v.ndim:
            raise StridedLayoutError(f"too many indices for rank {v.ndim}")
        d = v.shape[axis]
        s = v.strides[axis]
        if isinstance(i, int) or (hasattr(i, "__index__") and not isinstance(i, bool)):
            i = operator.index(i)
            if i < 0:
                i += d
            if not (0 <= i < d):
                raise IndexError(f"index {i} out of bounds for dim {axis} size {d}")
            offset += i * s
        elif isinstance(i, slice):
            start, stop, step = i.indices(d)
            length = max(0, -(-(stop - start) // step)) if step > 0 else max(
                0, -(-(start - stop) // -step)
            )
            offset += start * s
            new_shape.append(length)
            new_strides.append(s * step)
        else:
            raise StridedLayoutError(
                f"unsupported index {i!r}: sview supports ints, slices, None, ..."
            )
        axis += 1
    return StridedView(v.parent, tuple(new_shape), tuple(new_strides), offset, v.conj)
