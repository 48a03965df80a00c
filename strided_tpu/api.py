"""User-facing API sugar — the analog of ``@strided`` and ``Array(...)``.

The reference's ``@strided`` macro (`/root/reference/src/macros.jl:1-43`)
rewrites an expression so every dense array becomes a ``StridedView``
(``maybestrided``), optimized kernels run, and results convert back
(``maybeunstrided``). In JAX the tracer plays the role of the macro
expander: :func:`strided_jit` wraps a function so dense array *arguments*
enter as lazy views, view *results* leave as dense arrays, and the whole body
is jit-compiled — one fused XLA/Pallas program, which is exactly what the
macro's "annotate a block and it gets fast" promise becomes under JAX.

``to_array`` is the ``Array(::StridedView)`` constructor family
(`/root/reference/src/convert.jl:3-15`) including eltype conversion through
the fused copy.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.view import StridedView, strided
from .core.regularize import materialize
from .core.lazy_expr import StridedExpr

__all__ = ["strided_jit", "maybe_strided", "maybe_unstrided", "to_array"]


def maybe_strided(x):
    """Dense array -> StridedView; anything else passes through
    (``maybestrided``, `/root/reference/src/macros.jl:31-34`)."""
    if isinstance(x, StridedView):
        return x
    if isinstance(x, (jax.Array, np.ndarray)) and getattr(x, "ndim", 0) > 0:
        return strided(jnp.asarray(x))
    return x


def maybe_unstrided(x):
    """StridedView (or lazy expression) -> dense array; anything else passes
    through (``maybeunstrided``, `/root/reference/src/macros.jl:35-43`). A
    pending :class:`StridedExpr` collapses into one fused kernel here."""
    if isinstance(x, (StridedView, StridedExpr)):
        return to_array(x)
    return x


def to_array(v, dtype=None) -> jax.Array:
    """Materialize a view or lazy expression to a dense array, optionally
    converting dtype through the same fused pass
    (`/root/reference/src/convert.jl:3-15`)."""
    if isinstance(v, StridedExpr):
        arr = v.materialize()
    else:
        arr = materialize(v)
    if dtype is not None:
        arr = arr.astype(dtype)
    return arr


def strided_jit(fun: Optional[Callable] = None, **jit_kwargs):
    """Decorator: run ``fun`` with array args wrapped as lazy strided views
    and view results materialized, under ``jax.jit``.

    Usage::

        @strided_jit
        def symmetrize(a):
            return (a + a.T) / 2      # a is a StridedView; ops are fused

    The pytree of positional/keyword args is mapped leaf-wise through
    ``maybe_strided``; outputs map through ``maybe_unstrided``.
    """

    def decorate(f: Callable) -> Callable:
        @functools.wraps(f)
        def inner(*args, **kwargs):
            is_view = lambda x: isinstance(x, StridedView)
            args = jax.tree_util.tree_map(maybe_strided, args, is_leaf=is_view)
            kwargs = jax.tree_util.tree_map(maybe_strided, kwargs, is_leaf=is_view)
            out = f(*args, **kwargs)
            return jax.tree_util.tree_map(
                maybe_unstrided,
                out,
                is_leaf=lambda x: isinstance(x, (StridedView, StridedExpr)),
            )

        return jax.jit(inner, **jit_kwargs)

    if fun is not None:
        return decorate(fun)
    return decorate
