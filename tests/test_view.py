"""L0 view-algebra tests: every lazy transform checked against a numpy
as_strided oracle, including randomized layout fuzzing over ranks 2..6 —
mirroring the reference's randomly-permuted-view tests
(`/root/reference/test/othertests.jl:17-44`) and its sreshape/sview semantics.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
from numpy.lib.stride_tricks import as_strided

import strided_tpu as st

from strided_tpu.core.view import (
    StridedView,
    StridedLayoutError,
    strided,
    permutedims,
    transpose,
    adjoint,
    conj,
    sreshape,
    sview,
    flip,
    broadcast_to,
    row_major_strides,
)
from strided_tpu.core.regularize import materialize, scatter_into, is_full_bijection


def oracle(v: StridedView) -> np.ndarray:
    """Numpy as_strided oracle for a view's logical contents."""
    flat = np.asarray(v.parent)
    itemsize = flat.dtype.itemsize
    base = flat[v.offset :] if min(v.strides, default=0) >= 0 else flat
    # as_strided with possibly-negative strides: compute from raw buffer.
    out = as_strided(
        flat[v.offset : v.offset + 1],
        shape=v.shape,
        strides=tuple(s * itemsize for s in v.strides),
    )
    out = np.array(out)  # copy out of the aliased memory
    return np.conj(out) if v.conj else out


def rand_view(shape, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    elif np.issubdtype(dtype, np.integer):
        x = rng.integers(-50, 50, size=shape).astype(dtype)
    else:
        x = rng.standard_normal(shape).astype(dtype)
    return x, strided(jnp.asarray(x))


def test_wrap_roundtrip():
    x, v = rand_view((3, 4, 5))
    assert v.shape == (3, 4, 5)
    assert v.strides == (20, 5, 1)
    np.testing.assert_array_equal(np.asarray(materialize(v)), x)


def test_permute_transpose_adjoint():
    x, v = rand_view((3, 4), dtype=np.complex128)
    np.testing.assert_array_equal(np.asarray(materialize(transpose(v))), x.T)
    np.testing.assert_array_equal(np.asarray(materialize(adjoint(v))), x.conj().T)
    np.testing.assert_array_equal(np.asarray(materialize(conj(v))), x.conj())
    x3, v3 = rand_view((2, 3, 4))
    np.testing.assert_array_equal(
        np.asarray(materialize(permutedims(v3, (2, 0, 1)))), np.transpose(x3, (2, 0, 1))
    )


def test_double_conj_is_identity():
    _, v = rand_view((3, 3), dtype=np.complex128)
    assert conj(conj(v)).conj is False


def test_sview_slicing():
    x, v = rand_view((6, 8, 10))
    cases = [
        (np.s_[1:5, :, 2:9:3], None),
        (np.s_[::2, 3, :], None),
        (np.s_[::-1, :, ::-2], None),
        (np.s_[2, 1:7:2, None, ::-1], None),
        (np.s_[..., 4], None),
    ]
    for idx, _ in cases:
        sv = sview(v, idx)
        np.testing.assert_array_equal(np.asarray(materialize(sv)), x[idx])


def test_sview_int_bounds():
    _, v = rand_view((4, 5))
    with pytest.raises(IndexError):
        sview(v, (4, 0))
    sv = sview(v, (-1, -2))
    assert sv.shape == ()


def test_flip():
    x, v = rand_view((5, 7))
    np.testing.assert_array_equal(np.asarray(materialize(flip(v, 0))), x[::-1])
    np.testing.assert_array_equal(
        np.asarray(materialize(flip(flip(v, 0), 0))), x
    )


def test_broadcast_to():
    x, v = rand_view((1, 5))
    b = broadcast_to(v, (4, 3, 5))
    assert b.strides[0] == 0 and b.strides[1] == 0
    np.testing.assert_array_equal(
        np.asarray(materialize(b)), np.broadcast_to(x, (4, 3, 5))
    )


def test_sreshape_contiguous():
    x, v = rand_view((4, 6))
    r = sreshape(v, (2, 2, 6))
    np.testing.assert_array_equal(np.asarray(materialize(r)), x.reshape(2, 2, 6))
    r2 = sreshape(v, (24,))
    np.testing.assert_array_equal(np.asarray(materialize(r2)), x.reshape(24))


def test_sreshape_of_permuted_errors():
    # Transposed matrix cannot be flattened without a copy — the reference
    # errors in this case (README.md:186-190).
    _, v = rand_view((4, 6))
    with pytest.raises(StridedLayoutError):
        sreshape(transpose(v), (24,))


def test_sreshape_partial_of_permuted():
    # Permuted view CAN be reshaped within contiguous chunks.
    x, v = rand_view((4, 6, 5))
    p = permutedims(v, (2, 0, 1))  # strides (1, 30, 5): dims (0|1,2) chunks
    r = sreshape(p, (5, 24))
    np.testing.assert_array_equal(
        np.asarray(materialize(r)), np.transpose(x, (2, 0, 1)).reshape(5, 24)
    )


def test_sreshape_split_sizes_with_ones():
    x, v = rand_view((12,))
    r = sreshape(v, (1, 3, 1, 4, 1))
    np.testing.assert_array_equal(
        np.asarray(materialize(r)), x.reshape(1, 3, 1, 4, 1)
    )


@pytest.mark.parametrize("rank", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32, np.complex128])
def test_fuzz_layouts(rank, dtype):
    """Randomized lazy-layout fuzzing vs the as_strided oracle: random chains
    of permute/slice/flip/conj, mirroring the reference's random-permutation
    test loops (`/root/reference/test/othertests.jl:17-44`)."""
    rng = np.random.default_rng(rank * 100 + 1)
    shape = tuple(rng.integers(2, 5) for _ in range(rank))
    x, v = rand_view(shape, dtype=dtype, seed=rank)
    ox = x
    for step in range(4):
        op = rng.integers(0, 4)
        if op == 0:
            perm = tuple(rng.permutation(v.ndim))
            v = permutedims(v, perm)
            ox = np.transpose(ox, perm)
        elif op == 1 and v.ndim > 0:
            ax = int(rng.integers(0, v.ndim))
            d = v.shape[ax]
            lo = int(rng.integers(0, d))
            hi = int(rng.integers(lo, d + 1))
            idx = tuple(
                slice(lo, hi) if k == ax else slice(None) for k in range(v.ndim)
            )
            v = sview(v, idx)
            ox = ox[idx]
        elif op == 2 and v.ndim > 0:
            ax = int(rng.integers(0, v.ndim))
            v = flip(v, ax)
            ox = np.flip(ox, ax)
        else:
            v = conj(v)
            if np.issubdtype(dtype, np.complexfloating):
                ox = np.conj(ox)
    got = np.asarray(materialize(v))
    np.testing.assert_array_equal(got, ox)


def test_overlapping_view_gather_fallback():
    # Hand-built overlapping layout (not producible via lazy ops): stride
    # smaller than inner extent. materialize must still be correct.
    x = np.arange(10.0)
    v = StridedView(jnp.asarray(x), shape=(4, 3), strides=(2, 1), offset=0)
    expect = as_strided(x, shape=(4, 3), strides=(16, 8))
    np.testing.assert_array_equal(np.asarray(materialize(v)), expect)


def test_zero_size():
    _, v = rand_view((3, 4))
    sv = sview(v, np.s_[1:1, :])
    assert sv.shape == (0, 4)
    assert materialize(sv).shape == (0, 4)


def test_is_full_bijection():
    _, v = rand_view((3, 4))
    assert is_full_bijection(v)
    assert is_full_bijection(transpose(v))
    assert is_full_bijection(flip(v, 0))
    assert not is_full_bijection(sview(v, np.s_[0:2, :]))
    assert not is_full_bijection(broadcast_to(strided(jnp.ones((1, 4))), (3, 4)))


@pytest.mark.parametrize("make", [
    lambda v: v,
    lambda v: transpose(v),
    lambda v: flip(v, 1),
    lambda v: permutedims(v, (1, 0)),
])
def test_scatter_into_bijection(make):
    x, v = rand_view((5, 7))
    tv = make(v)
    vals = np.random.default_rng(3).standard_normal(tv.shape)
    new_flat = scatter_into(tv, jnp.asarray(vals))
    # Read back through the same view: must equal vals.
    rv = StridedView(new_flat, tv.shape, tv.strides, tv.offset, tv.conj)
    np.testing.assert_allclose(np.asarray(materialize(rv)), vals)


def test_scatter_into_slice():
    x, v = rand_view((6, 6))
    tv = sview(v, np.s_[1:4, 2:6:2])
    vals = np.full(tv.shape, 99.0)
    new_flat = np.asarray(scatter_into(tv, jnp.asarray(vals))).reshape(6, 6)
    expect = x.copy()
    expect[1:4, 2:6:2] = 99.0
    np.testing.assert_array_equal(new_flat, expect)


def test_scatter_conj():
    x, v = rand_view((4, 4), dtype=np.complex128)
    tv = conj(v)
    vals = np.random.default_rng(5).standard_normal((4, 4)) + 1j
    new_flat = scatter_into(tv, jnp.asarray(vals))
    rv = StridedView(new_flat, tv.shape, tv.strides, tv.offset, tv.conj)
    np.testing.assert_allclose(np.asarray(materialize(rv)), vals)


# -- indexed in-place assignment sugar (dotview analog) ---


def test_at_set_scalar_and_slice():
    a = np.arange(40.0).reshape(5, 8)
    v = st.strided(jnp.asarray(a))
    got = v.at[1:4, ::2].set(-1.0)
    ref = a.copy()
    ref[1:4, ::2] = -1.0
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert got.shape == v.shape


def test_at_set_expr_one_liner():
    """`B[::2, :] = 2*A[:3]`-equivalent one-liner vs the numpy oracle —
    the reference's `B[rng] .= ...` dotview experience
    (`/root/reference/src/broadcast.jl:24`)."""
    b = np.random.default_rng(0).standard_normal((6, 7))
    a = np.random.default_rng(1).standard_normal((10, 7))
    B = st.strided(jnp.asarray(b))
    A = st.strided(jnp.asarray(a))
    got = B.at[::2, :].set(2 * A[:3])
    ref = b.copy()
    ref[::2, :] = 2 * a[:3]
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)


def test_at_add_mul_apply():
    a = np.random.default_rng(2).standard_normal((4, 6))
    v = st.strided(jnp.asarray(a))
    got = v.at[2].add(5.0)
    ref = a.copy(); ref[2] += 5.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)
    got = v.at[:, 1].mul(0.5)
    ref = a.copy(); ref[:, 1] *= 0.5
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)
    got = v.at[1:3, 2:5].apply(jnp.add, v[1:3, 2:5], 1.0)
    ref = a.copy(); ref[1:3, 2:5] += 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)


def test_at_set_through_transposed_view():
    # destination is itself a lazy transpose: writes go through the layout
    a = np.random.default_rng(3).standard_normal((5, 3))
    v = st.transpose(st.strided(jnp.asarray(a)))  # logical (3, 5)
    got = v.at[1, :].set(9.0)
    ref = a.T.copy(); ref[1, :] = 9.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)


def test_at_set_broadcasts_rhs():
    a = np.zeros((4, 6))
    v = st.strided(jnp.asarray(a))
    col = np.arange(4.0)
    got = st.set_view(v, (slice(None), slice(1, 5)), st.strided(jnp.asarray(col))[:, None])
    ref = a.copy(); ref[:, 1:5] = col[:, None]
    np.testing.assert_array_equal(np.asarray(got), ref)


# -- foreign-strided adoption ---------------------------
# The reference constructor re-derives strided layouts from SubArray/
# ReshapedArray parents at runtime (/root/reference/README.md:237-250);
# strided() does the same from numpy .strides instead of densifying.


def test_adopt_numpy_transpose_no_densify():
    a = np.random.default_rng(5).standard_normal((6, 9))
    v = st.strided(a.T)  # F-ordered view of a C array
    assert v.shape == (9, 6)
    assert v.strides == (1, 9)  # adopted layout, NOT row-major densified
    assert v.offset == 0
    np.testing.assert_array_equal(np.asarray(materialize(v)), a.T)


def test_adopt_numpy_window_and_negative_steps():
    a = np.random.default_rng(6).standard_normal((10, 12))
    w = a[2:8:2, ::-3]  # offset + mixed-sign steps
    v = st.strided(w)
    np.testing.assert_array_equal(np.asarray(materialize(v)), w)
    assert v.strides == (24, -3)
    s = np.arange(20.0)
    sw = as_strided(s, shape=(4, 5), strides=(8 * 4, 8))  # overlapping rows
    vw = st.strided(sw)
    assert vw.strides == (4, 1)
    np.testing.assert_array_equal(np.asarray(materialize(vw)), sw)


def test_adopt_numpy_fortran_base():
    a = np.asfortranarray(np.random.default_rng(7).standard_normal((5, 7)))
    w = a[1:, 2:]
    v = st.strided(w)
    np.testing.assert_array_equal(np.asarray(materialize(v)), w)
    # F layout: column stride 1, row stride 1 element apart in memory order
    assert v.strides == (1, 5)


def test_adopt_numpy_rejects_unaligned():
    a = np.zeros(16, np.float32)
    bad = as_strided(a, shape=(3,), strides=(2,))  # 2 B stride on 4 B elems
    with pytest.raises(StridedLayoutError):
        st.strided(bad)
    assert not st.isstrided(bad)


def test_isstrided_predicate():
    a = np.random.default_rng(8).standard_normal((4, 4))
    assert st.isstrided(a)
    assert st.isstrided(a.T)
    assert st.isstrided(jnp.zeros((2, 2)))
    assert st.isstrided(st.strided(a))
    assert not st.isstrided("not an array")


def test_adopted_view_feeds_engine():
    # an adopted transposed numpy array flows through the fused engine
    a = np.random.default_rng(9).standard_normal((64, 64)).astype(np.float32)
    v = st.strided(a.T)
    got = np.asarray((v + 1.0).materialize())
    np.testing.assert_allclose(got, a.T + 1.0, rtol=1e-6)
