"""Lowering strided views to XLA — the replacement for pointer arithmetic.

The reference's kernel walks arbitrary strided memory with pointer-bump
arithmetic (`/root/reference/src/mapreduce.jl:280-308`). XLA has no
arbitrary-stride loads: a view must instead be *decomposed* into a recipe of
XLA ops — ``slice`` + ``pad`` + ``reshape`` + ``rev`` + ``transpose`` +
``broadcast_in_dim`` + ``conj`` — each of which XLA fuses into the consumer.
This module implements that decomposition for any ``(shape, strides, offset)``
triple, with a ``gather`` fallback for pathological (overlapping) layouts that
the reference technically permits but never produces through its own lazy ops.

Terminology: a view's *decomposition* classifies each logical dim as either a
broadcast dim (stride 0, or size 1) or a *real* dim; real dims are flipped to
positive stride and sorted by descending stride, giving a canonical
"physical" order in which the flat buffer can be carved up by a
pad/reshape/slice cascade.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .view import StridedView, StridedLayoutError, row_major_strides

__all__ = [
    "Decomposition",
    "decompose",
    "materialize",
    "scatter_into",
    "is_full_bijection",
]


@dataclass(frozen=True)
class Decomposition:
    """Static description of how a view maps onto its flat parent.

    - ``real_axes``: logical axes with a genuine stride (size > 1, stride != 0),
      listed in *physical* order (descending |stride|).
    - ``sizes``/``strides``: matching physical-order sizes and |strides|.
    - ``flipped``: physical-order flags for negative logical strides.
    - ``min_offset``: flat index of the smallest-address element.
    - ``extent``: number of flat elements spanned (1 + sum (d-1)*s).
    - ``overlapping``: True when the pad/reshape/slice cascade is impossible
      (rows would overlap) and a gather fallback is required.
    """

    shape: Tuple[int, ...]
    real_axes: Tuple[int, ...]
    sizes: Tuple[int, ...]
    strides: Tuple[int, ...]
    flipped: Tuple[bool, ...]
    min_offset: int
    extent: int
    overlapping: bool


def decompose(shape, strides, offset) -> Decomposition:
    shape = tuple(int(d) for d in shape)
    strides = tuple(int(s) for s in strides)
    real = []  # (|stride|, size, axis, flipped)
    min_offset = offset
    for axis, (d, s) in enumerate(zip(shape, strides)):
        if d == 1 or s == 0:
            continue
        if s < 0:
            min_offset += (d - 1) * s
            real.append((-s, d, axis, True))
        else:
            real.append((s, d, axis, False))
    # Physical order: descending stride. Ties broken by logical axis for
    # determinism (ties with both sizes > 1 imply overlap anyway).
    real.sort(key=lambda t: (-t[0], t[2]))
    extent = 1 + sum((d - 1) * s for s, d, _, _ in real)
    overlapping = False
    inner = 1
    for s, d, _, _ in reversed(real):
        if s < inner:
            overlapping = True
        inner = (d - 1) * s + inner if s >= inner else max(inner, (d - 1) * s + 1)
    return Decomposition(
        shape=shape,
        real_axes=tuple(t[2] for t in real),
        sizes=tuple(t[1] for t in real),
        strides=tuple(t[0] for t in real),
        flipped=tuple(t[3] for t in real),
        min_offset=min_offset,
        extent=extent,
        overlapping=overlapping,
    )


def _extract_physical(flat: jax.Array, dec: Decomposition) -> jax.Array:
    """Carve the physical-order dense array out of the flat buffer.

    Cascade: for each physical dim (outermost first), pad the trailing axis
    to ``d * s`` elements, reshape it to ``(d, s)``, and keep the leading
    ``inner_extent`` columns. Every step is a pad/reshape/slice, which XLA
    folds into the consuming fusion — this is the whole-module replacement
    for the reference's per-dim pointer bumps
    (`/root/reference/src/mapreduce.jl:280-308`)."""
    if dec.min_offset < 0 or dec.min_offset + dec.extent > flat.shape[0]:
        raise StridedLayoutError(
            f"view spans [{dec.min_offset}, {dec.min_offset + dec.extent}) "
            f"outside parent of length {flat.shape[0]}"
        )
    arr = lax.slice(flat, (dec.min_offset,), (dec.min_offset + dec.extent,))
    n = len(dec.sizes)
    # inner_extent[k] = extent of dims k+1..n-1
    inner_extents = [1] * (n + 1)
    for k in range(n - 1, -1, -1):
        inner_extents[k] = inner_extents[k + 1] + (dec.sizes[k] - 1) * dec.strides[k]
    lead: Tuple[int, ...] = ()
    for k in range(n):
        d, s = dec.sizes[k], dec.strides[k]
        cur = arr.shape[-1]
        need = d * s
        if cur < need:
            pad = [(0, 0, 0)] * (len(lead)) + [(0, need - cur, 0)]
            arr = lax.pad(arr, jnp.zeros((), arr.dtype), pad)
        elif cur > need:
            arr = lax.slice_in_dim(arr, 0, need, axis=len(lead))
        arr = arr.reshape(*lead, d, s)
        inner = inner_extents[k + 1]
        if s != inner:
            arr = lax.slice_in_dim(arr, 0, inner, axis=len(lead) + 1)
        lead = lead + (d,)
    # arr now has shape (*sizes, 1)
    return arr.reshape(dec.sizes)


def _gather_physical(flat: jax.Array, dec: Decomposition) -> jax.Array:
    """Fallback for overlapping layouts: explicit index arithmetic + take."""
    idx = jnp.full((1,) * len(dec.sizes), dec.min_offset, dtype=jnp.int32)
    for k, (d, s) in enumerate(zip(dec.sizes, dec.strides)):
        shape = [1] * len(dec.sizes)
        shape[k] = d
        idx = idx + (jnp.arange(d, dtype=jnp.int32) * s).reshape(shape)
    return jnp.take(flat, idx.reshape(-1), axis=0).reshape(dec.sizes)


def materialize(v: StridedView) -> jax.Array:
    """Produce the logical dense array for a view.

    This is the analog of ``Array(::StridedView)``
    (`/root/reference/src/convert.jl:3-15`) but lazy in the XLA sense: under
    ``jit`` the emitted ops fuse into whatever consumes the result, so a
    materialize feeding an elementwise op costs one fused pass over HBM."""
    if 0 in v.shape:
        return jnp.zeros(v.shape, v.dtype)
    dec = decompose(v.shape, v.strides, v.offset)
    flat = v.parent
    if dec.overlapping:
        arr = _gather_physical(flat, dec)
    else:
        arr = _extract_physical(flat, dec)
    # Un-flip negative-stride dims.
    rev_axes = [k for k, f in enumerate(dec.flipped) if f]
    if rev_axes:
        arr = lax.rev(arr, rev_axes)
    # Place physical dims into their logical positions and broadcast the rest.
    # broadcast_in_dim needs strictly increasing dims: transpose first.
    if dec.real_axes:
        order = sorted(range(len(dec.real_axes)), key=lambda k: dec.real_axes[k])
        if order != list(range(len(order))):
            arr = lax.transpose(arr, order)
        arr = lax.broadcast_in_dim(arr, v.shape, tuple(sorted(dec.real_axes)))
    else:
        arr = lax.broadcast_in_dim(arr.reshape(()), v.shape, ())
    if v.conj:
        arr = jnp.conj(arr)
    return arr


def is_full_bijection(v: StridedView) -> bool:
    """True when the view is a bijective relabeling of its entire parent:
    writes through it can be lowered to transpose+reshape instead of scatter.

    Requires: no broadcast dims, exact nested strides in physical order with
    innermost stride 1, zero min-offset, and full coverage of the parent."""
    if 0 in v.shape:
        return int(v.parent.shape[0]) == 0
    dec = decompose(v.shape, v.strides, v.offset)
    if dec.overlapping or dec.min_offset != 0:
        return False
    if len(dec.real_axes) != sum(1 for d in v.shape if d != 1):
        return False  # some size>1 dim has stride 0
    # exact nesting: s_k == d_{k+1} * s_{k+1}, innermost stride 1
    n = len(dec.sizes)
    if n == 0:
        return int(v.parent.shape[0]) == 1
    if dec.strides[-1] != 1:
        return False
    for k in range(n - 1):
        if dec.strides[k] != dec.sizes[k + 1] * dec.strides[k + 1]:
            return False
    return math.prod(dec.sizes) == int(v.parent.shape[0])


def _insert_physical(parent: jax.Array, values_phys: jax.Array, dec: Decomposition) -> jax.Array:
    """Inverse of :func:`_extract_physical`: place physical-order
    ``values_phys`` into the window ``[min_offset, min_offset+extent)`` of the
    flat parent using only pad/reshape/slice + one ``dynamic_update_slice`` —
    NO index tensors, NO scatter (the zero-allocation write path of the
    reference's ``map!``, `/root/reference/src/mapreduce.jl:38-53`).

    Requires a non-overlapping decomposition. When the layout has gaps
    (stride > nested extent somewhere), untouched elements are preserved by
    building a same-shaped boolean mask through the identical cascade and
    selecting against the old window contents."""
    if dec.min_offset < 0 or dec.min_offset + dec.extent > parent.shape[0]:
        raise StridedLayoutError(
            f"view spans [{dec.min_offset}, {dec.min_offset + dec.extent}) "
            f"outside parent of length {parent.shape[0]}"
        )
    n = len(dec.sizes)
    if n == 0:
        return lax.dynamic_update_slice(
            parent, values_phys.reshape(1), (dec.min_offset,)
        )
    inner_extents = [1] * (n + 1)
    for k in range(n - 1, -1, -1):
        inner_extents[k] = inner_extents[k + 1] + (dec.sizes[k] - 1) * dec.strides[k]
    # Gap-free layout: every stride equals the nested inner extent, so the
    # window is a dense row-major relabeling of the values — plain dus.
    dense = all(dec.strides[k] == inner_extents[k + 1] for k in range(n))
    arr = values_phys.reshape(dec.sizes + (1,))
    mask = None if dense else jnp.ones(dec.sizes + (1,), jnp.bool_)

    def cascade(a, fill):
        for k in range(n - 1, -1, -1):
            s = dec.strides[k]
            cur = a.shape[-1]  # == inner_extents[k + 1]
            if s > cur:
                cfg = [(0, 0, 0)] * (a.ndim - 1) + [(0, s - cur, 0)]
                a = lax.pad(a, fill, cfg)
            width = max(s, cur)
            a = a.reshape(a.shape[:-2] + (dec.sizes[k] * width,))
            if a.shape[-1] > inner_extents[k]:
                a = lax.slice_in_dim(a, 0, inner_extents[k], axis=a.ndim - 1)
        return a  # shape (extent,)

    arr = cascade(arr, jnp.zeros((), arr.dtype))
    if dense and dec.extent == parent.shape[0]:
        return arr  # full coverage: the whole buffer is replaced
    if mask is None:
        return lax.dynamic_update_slice(parent, arr, (dec.min_offset,))
    mask = cascade(mask, jnp.zeros((), jnp.bool_))
    old = lax.dynamic_slice(parent, (dec.min_offset,), (dec.extent,))
    return lax.dynamic_update_slice(
        parent, jnp.where(mask, arr, old), (dec.min_offset,)
    )


def scatter_into(v: StridedView, values: jax.Array) -> jax.Array:
    """Write dense ``values`` (logical shape of ``v``) through the view,
    returning the **new flat parent buffer** (functional update).

    Fast paths: when the view is a full bijection of its parent, the write is
    an inverse transpose/reshape — zero cost; any other non-overlapping view
    lowers to the inverse pad/reshape/slice cascade of
    :func:`_insert_physical` (one windowed dense update — no index tensors).
    Only layouts that visit a parent element more than once (overlapping
    strides, broadcast write-dims) fall back to an indexed scatter. Writing
    through ``conj`` applies the inverse conjugation, matching
    ``ParentIndex`` write semantics
    (`/root/reference/src/mapreduce.jl:276-278`)."""
    values = jnp.asarray(values)
    if values.shape != v.shape:
        raise StridedLayoutError(
            f"scatter_into: value shape {values.shape} != view shape {v.shape}"
        )
    if v.conj:
        values = jnp.conj(values)
    values = values.astype(v.dtype)
    if 0 in v.shape:
        return v.parent
    dec = decompose(v.shape, v.strides, v.offset)
    if is_full_bijection(v):
        # values[logical] -> physical order -> undo flips -> flatten
        arr = values
        if any(d == 1 for d in v.shape):
            arr = arr.reshape([d for d in v.shape if d != 1])
        # after squeeze, logical real axes renumber; map physical order
        kept = [a for a in range(len(v.shape)) if v.shape[a] != 1]
        renum = {a: i for i, a in enumerate(kept)}
        perm = tuple(renum[a] for a in dec.real_axes)
        if perm:
            arr = lax.transpose(arr, perm)
        rev_axes = [k for k, f in enumerate(dec.flipped) if f]
        if rev_axes:
            arr = lax.rev(arr, rev_axes)
        return arr.reshape(-1)
    # Windowed inverse-recipe path: any non-overlapping,
    # non-duplicating view writes through pad/reshape/slice + one dus.
    has_broadcast_write = any(
        d > 1 and s == 0 for d, s in zip(v.shape, v.strides)
    )
    if not dec.overlapping and not has_broadcast_write:
        arr = values
        if any(d == 1 for d in v.shape):
            arr = arr.reshape([d for d in v.shape if d != 1])
        kept = [a for a in range(len(v.shape)) if v.shape[a] != 1]
        renum = {a: i for i, a in enumerate(kept)}
        perm = tuple(renum[a] for a in dec.real_axes)
        if perm and perm != tuple(range(len(perm))):
            arr = lax.transpose(arr, perm)
        rev_axes = [k for k, f in enumerate(dec.flipped) if f]
        if rev_axes:
            arr = lax.rev(arr, rev_axes)
        return _insert_physical(v.parent, arr, dec)

    # Last resort (overlapping or duplicated writes): indexed functional
    # update on the flat buffer — scatter semantics are genuinely needed.
    idx = jnp.full((1,) * len(v.shape), v.offset, dtype=jnp.int32)
    for k, (d, s) in enumerate(zip(v.shape, v.strides)):
        shape = [1] * len(v.shape)
        shape[k] = d
        idx = idx + (jnp.arange(d, dtype=jnp.int32) * s).reshape(shape)
    return v.parent.at[idx.reshape(-1)].set(values.reshape(-1))
