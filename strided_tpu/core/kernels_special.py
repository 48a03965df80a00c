"""Tile-pair Pallas kernel for transpose-pair workloads.

:func:`pair_axpby` computes ``B = epilogue(alpha*A + beta*C^T)`` — the
reference's flagship benchmark family: ``B .= (A .+ A')./2`` (symmetrize,
`/root/reference/README.md:69-73`), ``axpby!``-transpose
(`/root/reference/src/linalg.jl:39-42`), antisymmetrize ``A - A'``, and
(direct calls only) the single-term ``3 .* A'`` and distinct-buffer
``A + B'`` variants. The expression-layer dispatch sends only the
same-buffer two-term family here (see ``lazy_expr.try_pattern_expr``).

Why a dedicated kernel: a fused elementwise lowering of ``A + A.T`` reads
every element twice (once plain, once through the transpose) and writes it
once — 12 bytes per f32 element. This kernel walks tile *pairs*
``(i, j)`` / ``(j, i)`` of the upper triangle: one program loads both
mirror tiles, transposes them in registers/shared memory, and writes both
output tiles, so each input element is read once and each output element
written once — 8 bytes per element. One program writing two disjoint
output tiles is what a fused XLA expression cannot express.

Written for the GPU through Pallas's Triton route: power-of-two square
tiles, masked loads and stores for the ragged edge (any ``n``, e.g. the
reference's literal 4000x4000), and the (i, j) worklist passed as two
int32 index arrays that each program reads at its own ``program_id``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import get_config, kernel_mode

__all__ = ["symmetrize", "pair_axpby", "pair_kernel_tile"]

_OK_DTYPES = ("float32", "bfloat16")
# Square tile edge and warps per program (one tile pair per program).
PAIR_TILE = 64
PAIR_NUM_WARPS = 4


def pair_kernel_tile(n: int, m: int, dtype, distinct: bool = False):
    """Shared eligibility predicate for the pair kernel: returns the tile
    size the kernel would use, or ``None`` when the kernel cannot run and
    callers must take the fused XLA expression. This is the single gate
    both :func:`pair_axpby` and the lazy-expression pattern dispatch
    consult, so the dispatch can never claim the kernel path while the
    kernel silently falls back."""
    cfg = get_config()
    if kernel_mode() is None:
        return None
    if n != m or n == 0 or str(dtype) not in _OK_DTYPES:
        return None
    if n * n < cfg.pair_kernel_min_elements:
        return None
    return PAIR_TILE


def _apply_coeff(t, c: float):
    # x*1.0 == x and -(x) == -1.0*x bit-exactly in IEEE; the shortcuts only
    # skip redundant multiplies.
    if c == 1.0:
        return t
    if c == -1.0:
        return -t
    return t * c


def _epilogue(S, scale_mode, scale):
    """The top-level scale node of the source expression — ONE definition
    shared by the kernel and the fallback so the
    bit-exact kernel/generic contract has a single point of truth."""
    if scale_mode == "mul":
        return S * scale
    if scale_mode == "div":
        return S / scale
    return S


def _pair_term(a, ct, alpha: float, beta: float, plain_first: bool = True):
    """``alpha*a + beta*ct`` with zero coefficients DROPPING their term
    entirely (not multiplied by 0): ``alpha == 0.0`` marks the
    single-transposed-term family (``3 .* A'``), whose generic spelling has
    no plain term at all — computing ``0*a + ...`` would differ on
    inf/NaN inputs and break the bit-exact kernel/generic contract.

    ``plain_first`` preserves the SOURCE expression's term order: a compiler
    may contract one of the two multiplies into an FMA and choose by
    operand order, so ``alpha*A + beta*C.T`` and ``beta*C.T + alpha*A`` can
    differ in the last ulp — the kernel adds in the same order as the
    generic closure. A ``beta == 0.0`` in a TWO-term source
    must still compute ``0 * ct`` (inf/NaN semantics — `0*inf = NaN`), so
    only ``alpha == 0.0`` (the marker for a source with no plain term at
    all) drops anything. ONE definition shared by the kernel and the
    fallback."""
    if alpha == 0.0:
        return _apply_coeff(ct, beta)
    ta, tb = _apply_coeff(a, alpha), _apply_coeff(ct, beta)
    return ta + tb if plain_first else tb + ta


def _make_pair_kernel(
    n: int,
    T: int,
    alpha: float,
    beta: float,
    scale_mode,  # None | 'mul' | 'div'
    scale: float,
    distinct: bool,
    plain_first: bool,
):
    """One program per upper-triangle tile pair (i, j), i <= j:

    same-buffer:   loads A[i,j], A[j,i]; distinct: also C[i,j], C[j,i]
    S1 = ep(alpha*A[i,j] + beta*C[j,i]^T)  -> B[i,j]
    S2 = ep(alpha*A[j,i] + beta*C[i,j]^T)  -> B[j,i]   (not stored on the
    diagonal, where it would duplicate S1)

    The op structure (coeff-multiply, add, then one epilogue mul/div)
    mirrors the generic fused expression, so kernel and generic paths agree
    for every supported spelling."""

    def epilogue(S):
        return _epilogue(S, scale_mode, scale)

    def kernel(ri_ref, rj_ref, *refs):
        if distinct:
            a_ref, c_ref, o_ref = refs
        else:
            a_ref, o_ref = refs
            c_ref = a_ref
        # Index math pinned to int32 (the default int is int64 under x64).
        k = jnp.asarray(pl.program_id(0), jnp.int32)
        r0 = ri_ref[k] * T
        c0 = rj_ref[k] * T
        idx = jnp.arange(T, dtype=jnp.int32)
        rows_ok = (r0 + idx) < n
        cols_ok = (c0 + idx) < n
        m_ij = rows_ok[:, None] & cols_ok[None, :]  # tile (i, j)
        m_ji = cols_ok[:, None] & rows_ok[None, :]  # tile (j, i)
        blk_ij = (pl.ds(r0, T), pl.ds(c0, T))
        blk_ji = (pl.ds(c0, T), pl.ds(r0, T))
        a1 = plgpu.load(a_ref.at[blk_ij], mask=m_ij, other=0)
        a2 = plgpu.load(a_ref.at[blk_ji], mask=m_ji, other=0)
        if distinct:
            c1 = plgpu.load(c_ref.at[blk_ij], mask=m_ij, other=0)
            c2 = plgpu.load(c_ref.at[blk_ji], mask=m_ji, other=0)
        else:
            c1, c2 = a1, a2
        S1 = epilogue(_pair_term(a1, c2.T, alpha, beta, plain_first))
        if not distinct and alpha == beta and alpha != 0.0:
            # symmetric case: S2 = alpha*a2 + beta*a1.T = S1.T exactly (the
            # epilogue commutes with transpose) — halves the arithmetic.
            S2 = S1.T
        else:
            S2 = epilogue(_pair_term(a2, c1.T, alpha, beta, plain_first))
        plgpu.store(o_ref.at[blk_ij], S1.astype(o_ref.dtype), mask=m_ij)
        plgpu.store(
            o_ref.at[blk_ji], S2.astype(o_ref.dtype), mask=m_ji & (r0 != c0)
        )

    return kernel


def _pair_fallback(a, c, alpha, beta, scale_mode, scale, plain_first=True):
    """Plain fused-XLA expression with the exact same op structure as the
    kernel (bit-identical results either way)."""
    S = _pair_term(a, (a if c is None else c).T, alpha, beta, plain_first)
    return _epilogue(S, scale_mode, scale)


@functools.partial(
    jax.jit,
    static_argnames=("alpha", "beta", "scale_mode", "scale", "plain_first"),
)
def pair_fallback_call(a, c, *, alpha, beta, scale_mode, scale,
                       plain_first=True):
    """Jitted wrapper over :func:`_pair_fallback` — the route the
    expression dispatch gives DISTINCT-buffer pairs. Jitted so eager use
    compiles the whole expression as one
    program (op-by-op eager compilation skips FMA contraction and drifts a
    ulp from the jitted spelling); under an enclosing jit it inlines."""
    return _pair_fallback(a, c, alpha, beta, scale_mode, scale, plain_first)


def pair_axpby(
    a: jax.Array,
    c: jax.Array = None,
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
    scale_mode=None,
    scale: float = 1.0,
    tile: int = None,
    plain_first: bool = True,
) -> jax.Array:
    """``epilogue(alpha*a + beta*c.T)`` via the tile-pair kernel.

    ``c`` defaults to ``a`` (the symmetrize family — one read and one write
    per element); a distinct ``c`` reads both buffers once.
    ``alpha``/``beta``/``scale`` are static Python floats — the
    lazy-expression pattern dispatch extracts them from literals like
    ``(v + v.T) / 2`` or ``3*v + 2*v.T``. ``scale_mode`` is ``None`` /
    ``'mul'`` / ``'div'``: the epilogue replicates the top-level node of the
    source expression so results match the generic path. ``tile`` (a power
    of two) overrides the size gate; the kernel still runs only where
    :func:`~strided_tpu.config.kernel_mode` offers kernels. Otherwise falls
    back to the plain fused expression.

    Eligibility is decided OUTSIDE the jit cache (config toggles take
    effect immediately in eager use; under an enclosing jit the decision is
    trace-time, like every dispatch decision in the engine)."""
    n, m = a.shape
    distinct = c is not None
    if distinct and (c.shape != a.shape or c.dtype != a.dtype):
        return _pair_fallback(a, c, alpha, beta, scale_mode, scale, plain_first)
    if tile is not None and (tile < 16 or tile & (tile - 1)):
        raise ValueError(f"pair kernel tile must be a power of two >= 16, got {tile}")
    mode = kernel_mode()
    T = tile if tile is not None else pair_kernel_tile(n, m, a.dtype, distinct)
    if (
        T is None
        or mode is None
        or n != m
        or n == 0
        or str(a.dtype) not in _OK_DTYPES
    ):
        return _pair_fallback(a, c, alpha, beta, scale_mode, scale, plain_first)
    operands = (a,) if c is None else (a, c)
    return _pair_call(n, T, float(alpha), float(beta), scale_mode, float(scale),
                      mode == "interpret", plain_first, distinct)(*operands)


@functools.lru_cache(maxsize=None)
def _pair_call(n, T, alpha, beta, scale_mode, scale, interpret, plain_first,
               distinct):
    """The jitted kernel call for one static configuration. Cached so that a
    call passes arrays only and takes jit's fast dispatch path (static
    keyword arguments would add host time to every eager call)."""
    ri, rj = np.triu_indices(-(-n // T))
    kernel = _make_pair_kernel(n, T, alpha, beta, scale_mode, scale, distinct,
                               plain_first)

    @jax.jit
    def call(*arrays):
        return pl.pallas_call(
            kernel,
            grid=(len(ri),),
            out_shape=jax.ShapeDtypeStruct((n, n), arrays[0].dtype),
            backend="triton",
            interpret=interpret,
            compiler_params=plgpu.CompilerParams(num_warps=PAIR_NUM_WARPS),
            name="pair_axpby",
        )(jnp.asarray(ri, jnp.int32), jnp.asarray(rj, jnp.int32), *arrays)

    return call


def symmetrize(a: jax.Array, tile: int = None, alpha: float = 0.5) -> jax.Array:
    """``(a + a.T) * alpha`` — the reference's flagship workload
    (`/root/reference/README.md:69-73`) through the tile-pair kernel.
    Square f32/bf16 matrices at or above ``Config.pair_kernel_min_elements``
    (or any size with an explicit ``tile``) hit the kernel where
    :func:`~strided_tpu.config.kernel_mode` offers one; everything else
    takes the identical-structure fused expression."""
    if alpha == 1.0:
        return pair_axpby(a, tile=tile)
    return pair_axpby(a, scale_mode="mul", scale=alpha, tile=tile)
