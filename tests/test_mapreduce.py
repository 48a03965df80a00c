"""Engine tests: map/copy/permute façades, complete + partial reductions,
and the initop contract — mirroring `/root/reference/test/othertests.jl:1-128`
(oracle comparison vs dense ops, random lazy layouts, exact int dtypes,
all five initop shapes)."""

import numpy as np
import pytest
import jax.numpy as jnp

import strided_tpu as st
from strided_tpu.core.mapreduce import (
    smap,
    map_into,
    copy_into,
    permutedims_into,
    adjoint_into,
    sreduce,
    sreduce_dims,
    mapreducedim_into,
)
from strided_tpu.core.broadcast import sbroadcast, sbroadcast_into
from strided_tpu.core.view import StridedView, StridedLayoutError
from strided_tpu.core.regularize import materialize


def rand(shape, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-20, 20, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


# -- in-place matrix ops vs oracle (othertests.jl:1-15) ---------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128, np.int32])
def test_permutedims_into(dtype):
    a = rand((13, 17, 5), dtype)
    out = st.strided(jnp.zeros((5, 13, 17), dtype))
    res = permutedims_into(out, jnp.asarray(a), (2, 0, 1))
    np.testing.assert_array_equal(np.asarray(materialize(res)), np.transpose(a, (2, 0, 1)))


def test_adjoint_into():
    a = rand((9, 6), np.complex128)
    out = st.strided(jnp.zeros((6, 9), np.complex128))
    res = adjoint_into(out, jnp.asarray(a))
    np.testing.assert_array_equal(np.asarray(materialize(res)), a.conj().T)


def test_copy_into_lazy_permuted_views():
    # copy through two different lazy layouts (dst strided slice)
    a = rand((8, 8))
    dst = st.strided(jnp.zeros((16, 16)))
    dv = st.sview(dst, np.s_[::2, ::2])
    res = copy_into(dv, st.transpose(st.strided(jnp.asarray(a))))
    full = np.zeros((16, 16))
    full[::2, ::2] = a.T
    np.testing.assert_array_equal(np.asarray(res.parent).reshape(16, 16), full)


# -- map over random lazy layouts, ranks 2..6 (othertests.jl:17-44) ---------


@pytest.mark.parametrize("rank", [2, 3, 4, 5, 6])
def test_map_random_permuted_views(rank):
    rng = np.random.default_rng(rank)
    shape = tuple(rng.integers(2, 5) for _ in range(rank))
    a = rand(shape, seed=rank)
    perm = tuple(rng.permutation(rank))
    va = st.permutedims(st.strided(jnp.asarray(a)), perm)
    res = smap(lambda x: jnp.sin(x) + 1.0, va)
    np.testing.assert_allclose(
        np.asarray(materialize(res)), np.sin(np.transpose(a, perm)) + 1.0, rtol=1e-12
    )


def test_map_into_shape_mismatch_raises():
    with pytest.raises(st.StridedLayoutError):
        map_into(st.strided(jnp.zeros((3, 3))), lambda x: x, st.strided(jnp.zeros((4, 3))))


def test_map_dtype_promotion():
    # analog of Base.map promotion (mapreduce.jl:32-36)
    a = st.strided(jnp.arange(6, dtype=jnp.int32).reshape(2, 3))
    b = st.strided(jnp.ones((2, 3), jnp.float64))
    res = smap(jnp.add, a, b)
    assert res.dtype == jnp.float64


# -- complete reductions (othertests.jl:109-128) ----------------------------


def test_sum_over_lazy_permute():
    a = rand((5, 6, 7))
    v = st.permutedims(st.strided(jnp.asarray(a)), (2, 0, 1))
    got = sreduce(lambda x: x, jnp.add, v)
    np.testing.assert_allclose(float(got), a.sum(), rtol=1e-12)


def test_mapreduce_sin_plus():
    a = rand((11, 13))
    got = sreduce(jnp.sin, jnp.add, st.strided(jnp.asarray(a)))
    np.testing.assert_allclose(float(got), np.sin(a).sum(), rtol=1e-12)


def test_counting_bool_reduction():
    # sum(x -> real(x) < 0, A): Bool + counting (othertests.jl:117-121)
    a = rand((10, 10), np.complex128)
    got = sreduce(lambda x: (jnp.real(x) < 0).astype(jnp.int32), jnp.add,
                  st.strided(jnp.asarray(a)))
    assert int(got) == int((a.real < 0).sum())


def test_prod_exp_identity():
    # prod(exp(A)) ≈ exp(sum(A)) (othertests.jl:122-128)
    a = rand((6, 6)) * 0.01
    v = st.strided(jnp.asarray(a))
    p = float(sreduce(jnp.exp, jnp.multiply, v))
    s = float(sreduce(lambda x: x, jnp.add, v))
    np.testing.assert_allclose(p, np.exp(s), rtol=1e-10)


def _tree_fold_oracle(xs, op):
    """The engine's documented adjacent-pair tree order (left-to-right
    preserving; only associativity assumed — mapreduce's order is
    implementation-defined, matching Julia Base's contract)."""
    xs = list(xs)
    while len(xs) > 1:
        nxt = [op(xs[i], xs[i + 1]) for i in range(0, len(xs) - 1, 2)]
        if len(xs) % 2:
            nxt.append(xs[-1])
        xs = nxt
    return xs[0]


def test_reduce_unknown_op_fold():
    # op with unknown identity -> adjacent-pair tree fold
    a = rand((4, 5))
    v = st.strided(jnp.asarray(a))
    got = sreduce(lambda x: x, lambda p, q: jnp.arctan2(p, q), v)
    expect = _tree_fold_oracle(a.reshape(-1), np.arctan2)
    np.testing.assert_allclose(float(got), expect, rtol=1e-12)


def test_reduce_unknown_op_associative_matches_any_order():
    # an associative op outside the identity table: a (+) b = a + b + a*b
    a = rand((13, 17)) * 0.01
    v = st.strided(jnp.asarray(a))
    weird = lambda p, q: p + q + p * q
    got = float(sreduce(lambda x: x, weird, v))
    # associative closed form: 1 + fold = prod(1 + x)
    np.testing.assert_allclose(got, np.prod(1 + a) - 1, rtol=1e-10)


def test_reduce_unknown_op_scales_without_scan():
    """The unknown-op fold must lower to O(log n) vectorized ops, never a
    per-element scan (the de-trap: the reference *errors* here under
    threading, /root/reference/src/mapreduce.jl:188-191; we fold in
    log-depth instead)."""
    import jax

    a = rand((512, 512))
    v = st.strided(jnp.asarray(a))
    weird = lambda p, q: jnp.arctan2(p, q)
    jaxpr = jax.make_jaxpr(lambda x: sreduce(lambda y: y, weird, st.strided(x)))(
        jnp.asarray(a)
    )
    s = str(jaxpr)
    assert "scan" not in s and "while" not in s
    # completes quickly even at this size
    got = float(sreduce(lambda x: x, weird, v))
    assert np.isfinite(got)


def test_reduce_min_max_int_exact():
    a = rand((7, 9), np.int32, seed=3)
    v = st.transpose(st.strided(jnp.asarray(a)))
    assert int(sreduce(lambda x: x, jnp.minimum, v)) == a.min()
    assert int(sreduce(lambda x: x, jnp.maximum, v)) == a.max()


# -- partial reductions + initop contract (othertests.jl:68-107) ------------


@pytest.mark.parametrize("axes", [(0,), (1,), (2,), (0, 2), (0, 1, 2)])
def test_sum_dims(axes):
    a = rand((5, 6, 7))
    v = st.strided(jnp.asarray(a))
    res = sreduce_dims(lambda x: x, jnp.add, v, axes)
    np.testing.assert_allclose(
        np.asarray(materialize(res)), a.sum(axis=axes, keepdims=True), rtol=1e-12
    )


def test_sum_dims_over_permuted_input():
    a = rand((4, 5, 6))
    v = st.permutedims(st.strided(jnp.asarray(a)), (1, 2, 0))
    res = sreduce_dims(lambda x: x, jnp.add, v, (1,))
    np.testing.assert_allclose(
        np.asarray(materialize(res)),
        np.transpose(a, (1, 2, 0)).sum(axis=1, keepdims=True),
        rtol=1e-12,
    )


@pytest.mark.parametrize(
    "initop_name", ["identity", "zero", "scale", "const", "conj"]
)
def test_mapreducedim_initop_shapes(initop_name):
    """The five initop shapes of the reference contract test
    (othertests.jl:68-107): identity, x->0, x->β*x, x->β, conj."""
    beta = 2.5
    a = rand((6, 4), np.float64, seed=7)
    c0 = rand((6, 1), np.float64, seed=8)
    initops = {
        "identity": (lambda x: x, lambda x: x),
        "zero": (lambda x: jnp.zeros_like(x), lambda x: np.zeros_like(x)),
        "scale": (lambda x: beta * x, lambda x: beta * x),
        "const": (lambda x: jnp.full_like(x, beta), lambda x: np.full_like(x, beta)),
        "conj": (jnp.conj, np.conj),
    }
    jop, nop = initops[initop_name]
    out = st.strided(jnp.asarray(c0.copy()))
    outb = st.broadcast_to(out, (6, 4))
    res = mapreducedim_into(lambda x: x * x, jnp.add, jop, outb,
                            st.strided(jnp.asarray(a)))
    expect = nop(c0) + (a * a).sum(axis=1, keepdims=True)
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(6, 1), expect, rtol=1e-12
    )


def test_mapreducedim_zero_size_applies_initop_only():
    # size-0 reduction dim: only initop applied (mapreduce.jl:86-96)
    beta = 3.0
    c0 = rand((4, 1))
    out = st.broadcast_to(st.strided(jnp.asarray(c0.copy())), (4, 0))
    res = mapreducedim_into(
        lambda x: x, jnp.add, lambda x: beta * x, out,
        st.strided(jnp.zeros((4, 0)))
    )
    np.testing.assert_allclose(np.asarray(res.parent).reshape(4, 1), beta * c0)


# -- broadcast front-end (othertests.jl:46-66) ------------------------------


def test_broadcast_fused_expression():
    a = rand((64, 64))
    A = st.strided(jnp.asarray(a))
    # B = (A + A') / 2
    res = sbroadcast(lambda x, y: (x + y) / 2, A, st.transpose(A))
    np.testing.assert_allclose(np.asarray(materialize(res)), (a + a.T) / 2, rtol=1e-15)


def test_broadcast_scalar_capture():
    a = rand((8, 8))
    A = st.strided(jnp.asarray(a))
    res = sbroadcast(lambda s, x: s * x, 3.0, st.transpose(A))
    np.testing.assert_allclose(np.asarray(materialize(res)), 3.0 * a.T, rtol=1e-15)


def test_broadcast_dims_mismatch_promotion():
    a = rand((4, 1, 5))
    b = rand((3, 5))
    res = sbroadcast(jnp.add, st.strided(jnp.asarray(a)), st.strided(jnp.asarray(b)))
    assert res.shape == (4, 3, 5)
    np.testing.assert_allclose(np.asarray(materialize(res)), a + b, rtol=1e-15)


def test_broadcast_into_strided_dst():
    a = rand((10, 10))
    dst = st.strided(jnp.zeros((10, 10)))
    dv = st.sview(dst, np.s_[::2, :])
    res = sbroadcast_into(dv, lambda x: 2 * x, st.sview(st.strided(jnp.asarray(a)), np.s_[:5, :]))
    full = np.zeros((10, 10))
    full[::2, :] = 2 * a[:5, :]
    np.testing.assert_allclose(np.asarray(res.parent).reshape(10, 10), full)


def test_operator_overloads():
    a = rand((6, 6))
    A = st.strided(jnp.asarray(a))
    res = (A + st.transpose(A)) / 2
    np.testing.assert_allclose(np.asarray(res), (a + a.T) / 2, rtol=1e-15)
    res2 = 3 * A - 1
    np.testing.assert_allclose(np.asarray(res2), 3 * a - 1, rtol=1e-15)


def test_fused_symmetrize_flagship():
    """The flagship call path: B .= (A .+ A')./2 (SURVEY.md §3.1)."""
    a = rand((128, 128))
    A = st.strided(jnp.asarray(a))
    B = st.strided(jnp.zeros((128, 128)))
    res = sbroadcast_into(B, lambda x, y: (x + y) / 2, A, st.transpose(A))
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(128, 128), (a + a.T) / 2, rtol=1e-15
    )


def test_fused_permute_sum():
    """Benchmark №5 workload: sum of 4 lazy permutes fused into one pass
    (README.md:101-105)."""
    a = rand((8, 8, 8, 8))
    A = st.strided(jnp.asarray(a))
    perms = [(0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2)]
    views = [st.permutedims(A, p) for p in perms]
    res = sbroadcast(lambda w, x, y, z: w + x + y + z, *views)
    expect = sum(np.transpose(a, p) for p in perms)
    np.testing.assert_allclose(np.asarray(materialize(res)), expect, rtol=1e-14)


def test_convenience_reductions():
    a = np.random.default_rng(42).standard_normal((7, 9))
    v = st.strided(jnp.asarray(a))
    np.testing.assert_allclose(float(st.ssum(v)), a.sum(), rtol=1e-12)
    np.testing.assert_allclose(float(st.smax(v)), a.max(), rtol=1e-12)
    np.testing.assert_allclose(float(st.smin(v)), a.min(), rtol=1e-12)
    np.testing.assert_allclose(float(st.smean(v)), a.mean(), rtol=1e-12)
    np.testing.assert_allclose(
        float(st.sprod(st.sbroadcast(jnp.abs, v))), np.prod(np.abs(a)), rtol=1e-9
    )
    # axis forms keep reduced dims at size 1 (Julia dims=... convention)
    s1 = st.ssum(v, 1)
    assert s1.shape == (7, 1)
    np.testing.assert_allclose(
        np.asarray(st.materialize(s1)).ravel(), a.sum(1), rtol=1e-12
    )
    m0 = st.smean(v, 0)
    np.testing.assert_allclose(
        np.asarray(st.materialize(m0)).ravel(), a.mean(0), rtol=1e-12
    )
    # over a lazy permuted view and over a lazy expression (fused)
    np.testing.assert_allclose(float(st.ssum(st.transpose(v))), a.sum(), rtol=1e-12)
    np.testing.assert_allclose(
        float(st.smax(v + st.transpose(st.strided(jnp.asarray(a.T))))),
        (2 * a).max(),
        rtol=1e-12,
    )


def test_map_scalar_operands_supported():
    """Python-scalar operands are captured, not iterated:
    map_into/smap must accept them exactly like sbroadcast does."""
    a = np.random.default_rng(0).standard_normal((8, 8))
    v = st.strided(jnp.asarray(a))
    out = st.smap(lambda x, s: x * s, v, 2.0)
    np.testing.assert_allclose(np.asarray(out), a * 2.0, rtol=1e-12)
    dst = st.strided(jnp.zeros((8, 8)))
    out = st.map_into(dst, lambda x, s, t: x * s + t, v, 3, 1.5)
    np.testing.assert_allclose(np.asarray(out), a * 3 + 1.5, rtol=1e-12)
    # genuine shape mismatch between ARRAY operands still raises cleanly
    with pytest.raises(StridedLayoutError):
        st.map_into(dst, jnp.add, v, st.strided(jnp.zeros((4, 4))))


def test_smean_axis_is_one_fused_pass(monkeypatch):
    """smean(axis) folds 1/n into the map stage: exactly ONE engine call."""
    from strided_tpu.core import mapreduce as mr

    calls = []
    real = mr.fused_mapreduce

    def spy(*args, **kwargs):
        calls.append(args[3])
        return real(*args, **kwargs)

    monkeypatch.setattr(mr, "fused_mapreduce", spy)
    a = np.random.default_rng(1).standard_normal((16, 12))
    v = st.strided(jnp.asarray(a))
    got = st.smean(v, 1)
    assert len(calls) == 1, f"smean(axis) ran {len(calls)} engine passes"
    np.testing.assert_allclose(
        np.asarray(got).ravel(), a.mean(1), rtol=1e-12
    )


# -- leading-axis partial reductions (the layouts a streaming reduction
# kernel would serve; XLA's reduction emitter runs them) ---------------------


def test_stream_reduce_axis0_exact_int():
    a = rand((320, 256), np.int32, seed=11)
    v = st.strided(jnp.asarray(a))
    got = sreduce_dims(lambda x: x, jnp.add, v, (0,))
    np.testing.assert_array_equal(
        np.asarray(got.parent).reshape(1, 256), a.sum(0, keepdims=True)
    )


def test_stream_reduce_transposed_view_and_ops():
    a = rand((256, 512), np.float32, seed=12)
    # sum over logical axis 1 of the LAZY TRANSPOSE = physical axis 0
    vt = st.transpose(st.strided(jnp.asarray(a)))  # logical (512, 256)
    got = sreduce_dims(lambda x: x, jnp.add, vt, (1,))
    np.testing.assert_allclose(
        np.asarray(got.parent).reshape(512), a.sum(0), rtol=1e-4,
        atol=1e-4,  # f32 accumulation-order tolerance
    )
    gmax = sreduce_dims(lambda x: x, jnp.maximum, st.strided(jnp.asarray(a)), (0,))
    np.testing.assert_array_equal(np.asarray(gmax.parent).reshape(512), a.max(0))


def test_stream_reduce_fused_map_and_declines():
    a = rand((256, 256), np.float32, seed=13)
    v = st.strided(jnp.asarray(a))
    # fused elementwise map + reduction in one pass
    got = sreduce_dims(jnp.abs, jnp.add, v, (0,))
    np.testing.assert_allclose(
        np.asarray(got.parent).reshape(256), np.abs(a).sum(0), rtol=1e-4,
        atol=1e-4,  # f32 accumulation order
    )
    # minor-axis reduction
    got2 = sreduce_dims(lambda x: x, jnp.add, v, (1,))
    np.testing.assert_allclose(
        np.asarray(got2.parent).reshape(256), a.sum(1), rtol=1e-4, atol=1e-4
    )
    # reduced row count not a multiple of 8
    a9 = rand((301, 256), np.float32, seed=19)
    got9 = sreduce_dims(lambda x: x, jnp.add, st.strided(jnp.asarray(a9)), (0,))
    np.testing.assert_allclose(
        np.asarray(got9.parent).reshape(256), a9.sum(0), rtol=1e-4, atol=1e-4
    )
    # windowed (non-bijective) view
    w = st.sview(st.strided(jnp.asarray(a)), (slice(0, 128), slice(None)))
    got3 = sreduce_dims(lambda x: x, jnp.add, w, (0,))
    np.testing.assert_allclose(
        np.asarray(got3.parent).reshape(256), a[:128].sum(0), rtol=1e-4,
        atol=1e-4
    )


def test_stream_reduce_3d_leading_axes_and_kept_minor():
    """Reduce the two leading logical axes of a 3-D view with ``init``
    seeding, and the leading axis alone (a kept block of two dims)."""
    a = rand((320, 16, 128), np.float32, seed=14)
    v = st.strided(jnp.asarray(a))
    got = sreduce_dims(lambda x: x, jnp.add, v, (0, 1), init=2.5)
    np.testing.assert_allclose(
        np.asarray(got.parent).reshape(128), a.sum((0, 1)) + 2.5,
        rtol=1e-3, atol=1e-3
    )
    got2 = sreduce_dims(lambda x: x, jnp.add, v, (0,))
    np.testing.assert_allclose(
        np.asarray(got2.parent).reshape(16, 128), a.sum(0),
        rtol=1e-4, atol=1e-4
    )


def test_stream_reduce_complete_sum_stays_on_xla():
    """Complete reductions over a lazy layout take the layout-invariance
    fast path (reduce the flat parent); values stay exact."""
    a = rand((512, 256), np.int32, seed=15)
    v = st.transpose(st.strided(jnp.asarray(a)))  # lazy layout
    got = sreduce(lambda x: x, jnp.add, v)
    assert int(got) == int(a.sum())
    gmin = sreduce(lambda x: x, jnp.minimum, st.strided(jnp.asarray(a)))
    assert int(gmin) == int(a.min())


# -- fused_mapreduce on scrambled layouts (the cases the removed tile
# executor served), checked against numpy ------------------------------------


def test_map_symmetrize():
    a = np.random.default_rng(0).standard_normal((256, 256)).astype(np.float32)
    A = st.strided(jnp.asarray(a))
    B = st.strided(jnp.zeros((256, 256), jnp.float32))
    res = st.fused_mapreduce(
        lambda x, y: (x + y) / 2, None, None, (256, 256), B, [A, st.transpose(A)]
    )
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(256, 256), (a + a.T) / 2, rtol=1e-6
    )


def test_map_into_transposed_out():
    # out itself is a lazy transpose (write-side permutation)
    a = np.random.default_rng(1).standard_normal((128, 256)).astype(np.float32)
    A = st.strided(jnp.asarray(a))
    buf = st.strided(jnp.zeros((256, 128), jnp.float32))
    out = st.transpose(buf)  # logical (128, 256)
    res = st.fused_mapreduce(lambda x: 2 * x, None, None, (128, 256), out, [A])
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(256, 128), 2 * a.T, rtol=1e-6
    )


def test_rank4_permute_copy():
    t = np.random.default_rng(2).standard_normal((16, 8, 16, 8)).astype(np.float32)
    T = st.strided(jnp.asarray(t))
    P = st.permutedims(T, (3, 2, 1, 0))
    out = st.strided(jnp.zeros((8, 16, 8, 16), jnp.float32))
    res = st.fused_mapreduce(lambda x: x, None, None, (8, 16, 8, 16), out, [P])
    np.testing.assert_array_equal(
        np.asarray(res.parent).reshape(8, 16, 8, 16),
        np.transpose(t, (3, 2, 1, 0)),
    )


def test_reduction_with_initop_beta():
    beta = 2.5
    a = np.random.default_rng(3).standard_normal((64, 1024)).astype(np.float32)
    c0 = np.random.default_rng(4).standard_normal((64,)).astype(np.float32)
    A = st.strided(jnp.asarray(a))
    out_buf = st.strided(jnp.asarray(c0.copy()))
    out = StridedView(out_buf.parent, (64, 1024), (1, 0), 0, False)
    res = st.fused_mapreduce(
        lambda x: x * x, jnp.add, lambda z: beta * z, (64, 1024), out, [A]
    )
    expect = beta * c0 + (a * a).sum(axis=1)
    np.testing.assert_allclose(np.asarray(res.parent), expect, rtol=2e-5)


def test_complete_reduction():
    a = np.random.default_rng(5).standard_normal((128, 128)).astype(np.float32)
    A = st.strided(jnp.asarray(a))
    out = StridedView(jnp.zeros((1,), jnp.float32), (128, 128), (0, 0), 0, False)
    res = st.fused_mapreduce(
        lambda x: x, jnp.add, lambda z: jnp.zeros_like(z), (128, 128), out, [A]
    )
    np.testing.assert_allclose(float(res.parent[0]), a.sum(), rtol=1e-4)


def test_broadcast_input():
    a = np.random.default_rng(6).standard_normal((128, 256)).astype(np.float32)
    row = np.random.default_rng(7).standard_normal((256,)).astype(np.float32)
    A = st.strided(jnp.asarray(a))
    R = st.broadcast_to(st.strided(jnp.asarray(row))[None, :], (128, 256))
    out = st.strided(jnp.zeros((128, 256), jnp.float32))
    res = st.fused_mapreduce(jnp.add, None, None, (128, 256), out, [A, R])
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(128, 256), a + row, rtol=1e-6
    )


def test_int32_exact():
    a = np.random.default_rng(8).integers(-100, 100, (64, 64)).astype(np.int32)
    A = st.strided(jnp.asarray(a))
    out = st.strided(jnp.zeros((64, 64), jnp.int32))
    res = st.fused_mapreduce(
        lambda x, y: x * y, None, None, (64, 64), out, [A, st.transpose(A)]
    )
    np.testing.assert_array_equal(np.asarray(res.parent).reshape(64, 64), a * a.T)


def test_min_reduction():
    a = np.random.default_rng(9).standard_normal((64, 512)).astype(np.float32)
    A = st.strided(jnp.asarray(a))
    out = StridedView(jnp.zeros((64,), jnp.float32), (64, 512), (1, 0), 0, False)
    res = st.fused_mapreduce(
        lambda x: x, jnp.minimum,
        lambda z: jnp.full_like(z, jnp.inf), (64, 512), out, [A],
    )
    np.testing.assert_allclose(np.asarray(res.parent), a.min(axis=1), rtol=1e-6)
