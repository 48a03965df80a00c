"""Lazy expression-tree fusion — the Broadcasted-analog contract.

The reference fuses an entire dot-expression into one kernel call
(`/root/reference/src/broadcast.jl:27-37`; flagship example
`/root/reference/README.md:101-105` — the 4-permute sum runs without
temporaries). These tests pin the same contract: operator chains on
StridedViews build a StridedExpr and collapse into exactly ONE
fused_mapreduce call at consumption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import strided_tpu as st
from strided_tpu import StridedExpr
from strided_tpu.core import mapreduce as mr


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float64)


def test_operators_build_lazy_exprs():
    v = st.strided(jnp.ones((4, 4)))
    e = (v + st.transpose(v)) / 2
    assert isinstance(e, StridedExpr)
    assert e.shape == (4, 4)
    assert len(e.leaves) == 2  # flattened: one level, all leaves inline


def test_expr_tree_flattens_nested():
    v = st.strided(jnp.ones((4, 4)))
    e = ((v + v) * (v - v)) + v
    assert isinstance(e, StridedExpr)
    assert len(e.leaves) == 5


def test_whole_tree_is_one_engine_call(monkeypatch):
    calls = []
    orig = mr.fused_mapreduce

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(mr, "fused_mapreduce", spy)
    # broadcast.py imported fused_mapreduce by value; patch there too
    from strided_tpu.core import broadcast as bc

    monkeypatch.setattr(bc, "fused_mapreduce", spy)

    a = rand((32, 32), 1)
    v = st.strided(jnp.asarray(a))
    e = (v + st.transpose(v)) * 0.5 - abs(-v)
    out = np.asarray(e)
    assert len(calls) == 1
    np.testing.assert_allclose(out, (a + a.T) * 0.5 - np.abs(a), rtol=1e-14)


def test_4permute_sum_fused_correct():
    d = 6
    a = rand((d, d, d, d), 2)
    v = st.strided(jnp.asarray(a))
    perms = [(1, 2, 3, 0), (2, 3, 0, 1), (3, 0, 1, 2), (0, 1, 2, 3)]
    e = (
        st.permutedims(v, perms[0])
        + st.permutedims(v, perms[1])
        + st.permutedims(v, perms[2])
        + st.permutedims(v, perms[3])
    )
    assert isinstance(e, StridedExpr) and len(e.leaves) == 4
    oracle = sum(a.transpose(p) for p in perms)
    np.testing.assert_allclose(np.asarray(e), oracle, rtol=1e-14)


def test_expr_into_reduction_fuses():
    a = rand((16, 16), 3)
    v = st.strided(jnp.asarray(a))
    e = (v + st.transpose(v)) / 2
    s = st.sreduce(lambda x: x, jnp.add, e)
    np.testing.assert_allclose(float(s), ((a + a.T) / 2).sum(), rtol=1e-12)
    sd = st.sreduce_dims(lambda x: x, jnp.add, e, 1)
    np.testing.assert_allclose(
        np.asarray(st.materialize(sd)).ravel(), ((a + a.T) / 2).sum(1), rtol=1e-12
    )
    np.testing.assert_allclose(np.asarray(e.sum()), ((a + a.T) / 2).sum(), rtol=1e-12)


def test_expr_as_sbroadcast_argument():
    a = rand((8, 8), 4)
    v = st.strided(jnp.asarray(a))
    e = v * 2.0
    r = st.sbroadcast(jnp.add, e, v)
    np.testing.assert_allclose(np.asarray(st.materialize(r)), 3 * a, rtol=1e-14)


def test_expr_in_map_into_and_smap():
    a = rand((8, 8), 5)
    v = st.strided(jnp.asarray(a))
    e = v + 1.0
    out = st.strided(jnp.zeros((8, 8)))
    res = st.map_into(out, lambda x: 2 * x, e)
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(8, 8), 2 * (a + 1), rtol=1e-14
    )
    r2 = st.smap(lambda x, y: x + y, e, v)
    np.testing.assert_allclose(
        np.asarray(st.materialize(r2)), 2 * a + 1, rtol=1e-14
    )


def test_scalar_and_raw_array_operands():
    a = rand((5, 7), 6)
    b = rand((5, 7), 7)
    v = st.strided(jnp.asarray(a))
    e = 3.0 * v + jnp.asarray(b)  # scalar embeds; raw array becomes a leaf
    assert isinstance(e, StridedExpr) and len(e.leaves) == 2
    np.testing.assert_allclose(np.asarray(e), 3 * a + b, rtol=1e-14)


def test_expr_dtype_promotion():
    v = st.strided(jnp.ones((3, 3), jnp.float32))
    w = st.strided(jnp.ones((3, 3), jnp.float64))
    assert (v + w).dtype == jnp.float64
    assert (v < w).dtype == jnp.bool_


def test_strided_jit_returns_dense_from_expr():
    a = rand((16, 16), 8)

    @st.strided_jit
    def f(x):
        return (x + st.transpose(x)) / 2  # returns a StridedExpr inside

    out = f(jnp.asarray(a))
    assert isinstance(out, jax.Array)
    np.testing.assert_allclose(np.asarray(out), (a + a.T) / 2, rtol=1e-14)


def test_broadcasting_inside_expr():
    a = rand((4, 6), 9)
    row = rand((6,), 10)
    e = st.strided(jnp.asarray(a)) + st.strided(jnp.asarray(row))
    assert e.shape == (4, 6)
    np.testing.assert_allclose(np.asarray(e), a + row, rtol=1e-14)


# ---- structured-pattern dispatch: alpha*A + beta*C.T -> tile-pair kernel ---
# The reference's flagship `B .= (A .+ A')./2` (README.md:69-73) and the
# axpby-transpose family (`/root/reference/src/linalg.jl:39-42`, README row 2)
# through the generic operator API; the lazy tree retains enough structure to
# route them to the tile-pair kernel (one read and one write per element).

from strided_tpu.core import lazy_expr as le


def _sym_input(n=256, dtype=jnp.float32, seed=3):
    a = jnp.asarray(np.random.default_rng(seed).standard_normal((n, n)), dtype)
    return a, st.strided(a)


@pytest.mark.parametrize(
    "build, oracle",
    [
        (lambda v: (v + st.transpose(v)) * 0.5, lambda a: (a + a.T) * 0.5),
        (lambda v: 0.5 * (v + st.transpose(v)), lambda a: (a + a.T) * 0.5),
        (lambda v: (v + st.transpose(v)) / 2, lambda a: (a + a.T) / 2),
        (lambda v: (st.transpose(v) + v) / 2, lambda a: (a + a.T) / 2),
        (lambda v: v + st.transpose(v), lambda a: a + a.T),
        (lambda v: (v + st.transpose(v)) * 3.0, lambda a: (a + a.T) * 3.0),
        # axpby-transpose family
        (lambda v: v - st.transpose(v), lambda a: a - a.T),
        (lambda v: 3.0 * v + 2.0 * st.transpose(v), lambda a: 3 * a + 2 * a.T),
        (lambda v: (3.0 * v - st.transpose(v) * 2.0) * 0.25,
         lambda a: (3 * a - a.T * 2) * 0.25),
        (lambda v: -v + st.transpose(v), lambda a: -a + a.T),
        # non-power-of-two divisor: kernel divides too -> still exact
        (lambda v: (v + st.transpose(v)) / 3, lambda a: (a + a.T) / 3),
    ],
)
def test_pair_pattern_dispatches_and_is_correct(build, oracle):
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, v = _sym_input()
        e = build(v)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(e)
        assert le.LAST_EXPR_DISPATCH == "pair-kernel"
        want = oracle(np.asarray(a, np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


@pytest.mark.parametrize(
    "build, oracle",
    [
        # distinct buffers: the 3-pass pair kernel (streaming reads only)
        (lambda v, w: (v + st.transpose(w)) * 0.5,
         lambda a, b: (a + b.T) * 0.5),
        (lambda v, w: v - st.transpose(w), lambda a, b: a - b.T),
        (lambda v, w: st.transpose(w) - v, lambda a, b: b.T - a),
        (lambda v, w: 2.0 * v + st.transpose(w) * 3.0,
         lambda a, b: 2 * a + b.T * 3),
    ],
)
def test_pair_pattern_distinct_buffers(build, oracle):
    """Distinct-buffer pairs route to the FUSED XLA expression: both
    buffers are read once either way, so the pair schedule saves no
    bytes."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, v = _sym_input(256)
        b, w = _sym_input(256, seed=4)
        e = build(v, w)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(e)
        assert le.LAST_EXPR_DISPATCH == "xla-pair"
        an, bn = np.asarray(a, np.float64), np.asarray(b, np.float64)
        np.testing.assert_allclose(got, oracle(an, bn), rtol=1e-5, atol=1e-5)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


@pytest.mark.parametrize("n", [320, 200, 400, 137])
def test_pair_pattern_non_divisible_sizes(n):
    """Edge-tile clamping: sizes NOT divisible by any
    kernel tile still dispatch; overlapping clamped tiles write bit-identical
    values. The reference's literal flagship is 4000x4000 (n % 512 != 0)."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, v = _sym_input(n, seed=7)
        e = (v + st.transpose(v)) / 2
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(e)
        assert le.LAST_EXPR_DISPATCH == "pair-kernel", n
        an = np.asarray(a, np.float64)
        np.testing.assert_allclose(got, (an + an.T) / 2, rtol=1e-6, atol=1e-6)
        # bit-exact vs the generic path (identical op structure)
        set_config(expr_pattern_dispatch=False)
        le.LAST_EXPR_DISPATCH = ""
        want_bits = np.asarray((v + st.transpose(v)) / 2)
        assert le.LAST_EXPR_DISPATCH == "generic"
        np.testing.assert_array_equal(got, want_bits)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_pair_pattern_in_place_routes():
    """copy_into(out, expr) and v.at[:].set(expr) hit the same kernel as the
    allocating spelling."""
    from strided_tpu.config import set_config, get_config
    from strided_tpu.core.mapreduce import copy_into

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, v = _sym_input(256, seed=9)
        an = np.asarray(a, np.float64)
        out = st.strided(jnp.zeros((256, 256), jnp.float32))
        le.LAST_EXPR_DISPATCH = ""
        res = copy_into(out, v + st.transpose(v))
        assert le.LAST_EXPR_DISPATCH == "pair-kernel"
        np.testing.assert_allclose(
            np.asarray(res.parent).reshape(256, 256), an + an.T, rtol=1e-6
        )
        out2 = st.strided(jnp.zeros((256, 256), jnp.float32))
        le.LAST_EXPR_DISPATCH = ""
        res2 = out2.at[:].set((v + st.transpose(v)) / 2)
        assert le.LAST_EXPR_DISPATCH == "pair-kernel"
        np.testing.assert_allclose(
            np.asarray(res2.parent).reshape(256, 256), (an + an.T) / 2, rtol=1e-6
        )
        # a windowed destination must NOT take the replace-parent shortcut
        big = st.strided(jnp.zeros((300, 300), jnp.float32))
        le.LAST_EXPR_DISPATCH = ""
        res3 = big.at[:256, :256].set(v + st.transpose(v))
        full = np.zeros((300, 300))
        full[:256, :256] = an + an.T
        np.testing.assert_allclose(
            np.asarray(res3.parent).reshape(300, 300), full, rtol=1e-6
        )
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_pair_pattern_eager_double_wrap():
    """Pins the documented eager-use caveat: two separate strided() wraps of
    the same array have different parent objects, so the SAME-buffer 2-pass
    match misses — but the expression still matches as a distinct-buffer
    pair (routed to fused XLA) and stays correct."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a = jnp.asarray(np.random.default_rng(11).standard_normal((256, 256)),
                        jnp.float32)
        e = st.strided(a) + st.transpose(st.strided(a))
        m = le._match_pair(e)
        assert m is not None
        A, C, alpha, beta, _, _, _ = m
        assert C is not None  # distinct-buffer match, not the 2-pass one
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(e)
        assert le.LAST_EXPR_DISPATCH == "xla-pair"
        an = np.asarray(a, np.float64)
        np.testing.assert_allclose(got, an + an.T, rtol=1e-6)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


@pytest.mark.parametrize(
    "build, oracle",
    [
        (lambda v, w: (v + v) * 0.5,                 # not a transpose pair
         lambda a, b: a),
        (lambda v, w: (v + st.transpose(v)) * w,     # non-scalar multiplier
         lambda a, b: (a + a.T) * b),
        (lambda v, w: v * st.transpose(v),           # multiply, not add/sub
         lambda a, b: a * a.T),
        (lambda v, w: (v + st.transpose(v)) + w,     # 3-term tree
         lambda a, b: (a + a.T) + b),
    ],
)
def test_pair_pattern_rejects_and_generic_is_correct(build, oracle):
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, v = _sym_input(128)
        b, w = _sym_input(128, seed=4)
        e = build(v, w)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(e)
        assert le.LAST_EXPR_DISPATCH == "generic"
        an, bn = np.asarray(a, np.float64), np.asarray(b, np.float64)
        np.testing.assert_allclose(got, oracle(an, bn), rtol=1e-5, atol=1e-5)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_symmetrize_pattern_rejects_non_square_and_small_and_offset():
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        # non-square parent
        a = jnp.asarray(rand((128, 64), 5), jnp.float32)
        v = st.strided(a)
        e = (v + st.transpose(st.strided(a.T.copy()))) * 0.5  # different parent
        le.LAST_EXPR_DISPATCH = ""
        np.asarray(e)
        assert le.LAST_EXPR_DISPATCH == "generic"
        # below the size gate (the pair kernel's own gate)
        set_config(pair_kernel_min_elements=1 << 30)
        _, v2 = _sym_input(128)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray((v2 + st.transpose(v2)) * 0.5)
        assert le.LAST_EXPR_DISPATCH == "generic"
        # a view into a larger buffer (offset/window) must not match
        set_config(pair_kernel_min_elements=1024)
        big = jnp.asarray(rand((200, 200), 6), jnp.float32)
        vw = st.sview(st.strided(big), (slice(0, 128), slice(0, 128)))
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray((vw + st.transpose(vw)) * 0.5)
        assert le.LAST_EXPR_DISPATCH == "generic"
        wantw = np.asarray(big, np.float64)[:128, :128]
        np.testing.assert_allclose(got, (wantw + wantw.T) * 0.5, rtol=1e-6)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_symmetrize_pattern_traced_scalar_stays_generic():
    """A traced (non-literal) scalar cannot be baked statically: the pattern
    must decline and the generic engine must produce the right value."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, _ = _sym_input(128)

        @jax.jit
        def f(x, s):
            v = st.strided(x)
            return st.to_array((v + st.transpose(v)) * s)

        got = np.asarray(f(a, 0.5))
        an = np.asarray(a, np.float64)
        np.testing.assert_allclose(got, (an + an.T) * 0.5, rtol=1e-6)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_symmetrize_pattern_config_toggle():
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True,
                   expr_pattern_dispatch=False)
        a, v = _sym_input(128)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray((v + st.transpose(v)) * 0.5)
        assert le.LAST_EXPR_DISPATCH == "generic"
        an = np.asarray(a, np.float64)
        np.testing.assert_allclose(got, (an + an.T) * 0.5, rtol=1e-6)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_pair_pattern_bfloat16():
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a = jnp.asarray(
            np.random.default_rng(17).standard_normal((256, 256)), jnp.bfloat16
        )
        v = st.strided(a)
        le.LAST_EXPR_DISPATCH = ""
        got = ((v + st.transpose(v)) / 2).materialize()
        assert le.LAST_EXPR_DISPATCH == "pair-kernel"
        want = jnp.asarray((a + a.T) / 2)
        assert got.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(got, np.float32), np.asarray(want, np.float32)
        )
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_pair_pattern_size_fuzz_bit_exact():
    """Randomized sizes x spellings: the clamped-core + strips composition
    must be bit-exact vs the generic path at EVERY size (the coverage proof
    for the edge handling)."""
    from strided_tpu.config import set_config, get_config

    rng = np.random.default_rng(42)
    spellings = [
        lambda v: (v + st.transpose(v)) / 2,
        lambda v: v - st.transpose(v),
        lambda v: 2.0 * v + st.transpose(v) * 0.5,
    ]
    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        for trial in range(6):
            n = int(rng.integers(128, 600))
            a = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
            v = st.strided(a)
            build = spellings[trial % len(spellings)]
            le.LAST_EXPR_DISPATCH = ""
            got = np.asarray(build(v))
            assert le.LAST_EXPR_DISPATCH == "pair-kernel", n
            set_config(expr_pattern_dispatch=False)
            want = np.asarray(build(st.strided(a)))
            set_config(expr_pattern_dispatch=True)
            np.testing.assert_array_equal(got, want, err_msg=f"n={n}")
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


@pytest.mark.parametrize(
    "build, xla",
    [
        # the reference's README row 2 family: B .= 3 .* A'
        (lambda v: 3.0 * st.transpose(v), lambda a: 3.0 * a.T),
        (lambda v: st.transpose(v) * 2.0, lambda a: a.T * 2.0),
        (lambda v: (st.transpose(v) * 2.0) / 4.0, lambda a: (a.T * 2.0) / 4.0),
        (lambda v: -st.transpose(v), lambda a: -a.T),
        (lambda v: (2.0 * st.transpose(v)) * 0.5, lambda a: (2.0 * a.T) * 0.5),
    ],
)
def test_single_transposed_term_stays_generic(build, xla):
    """``epilogue(c * v.T)`` — the single-transposed-term family (README row
    2, ``mul!(B, 3, A')`` `/root/reference/src/linalg.jl:22-31`) — is
    recognized by the matcher but dispatched to the GENERIC path: one read
    and one write per element either way, so the pair schedule saves no
    bytes over XLA's transpose emitter. Values pinned vs the XLA
    spelling."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, v = _sym_input(256, seed=11)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(build(v).materialize())
        assert le.LAST_EXPR_DISPATCH == "generic"
        want = np.asarray(jax.jit(xla)(a))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_single_term_plain_view_stays_generic():
    """A plain (non-transposed) scaled copy must NOT take the pair kernel —
    there is no transposed read for the pair schedule to save."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, v = _sym_input(256, seed=12)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray((3.0 * v).materialize())
        assert le.LAST_EXPR_DISPATCH == "generic"
        np.testing.assert_allclose(got, 3.0 * np.asarray(a), rtol=1e-6)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_pair_term_order_bit_exact():
    """Source term order is preserved through the kernel (``plain_first``):
    ``2*v.T + 3*v`` (plain term SECOND) and ``3*v + 2*v.T`` both dispatch
    to the kernel and match their XLA spellings to within 2 ulp of the
    terms' magnitude (|2 a.T| + |3 a|; cancellation can make the result
    itself tiny). The
    kernel is a separately compiled program (Triton on the GPU, one XLA
    CPU fusion in interpret mode), and which multiply the compiler
    contracts into an FMA is its own choice, so the last ulp may differ."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)
        a, v = _sym_input(256, seed=13)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray((2.0 * st.transpose(v) + 3.0 * v).materialize())
        assert le.LAST_EXPR_DISPATCH == "pair-kernel"
        want = np.asarray(jax.jit(lambda x: 2.0 * x.T + 3.0 * x)(a))
        bound = 2 * np.spacing(np.abs(2.0 * a).T + np.abs(3.0 * a))
        assert (np.abs(got - want) <= bound).all()
        # plain-first spelling too
        le.LAST_EXPR_DISPATCH = ""
        got2 = np.asarray((3.0 * v + 2.0 * st.transpose(v)).materialize())
        assert le.LAST_EXPR_DISPATCH == "pair-kernel"
        want2 = np.asarray(jax.jit(lambda x: 3.0 * x + 2.0 * x.T)(a))
        assert (np.abs(got2 - want2) <= bound).all()
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_expr_reduction_method_surface():
    """`.sum/.prod/.max/.min/.mean` work on views AND expressions — the othertests-style lazy-view reduction surface
    (`/root/reference/test/othertests.jl:109-128`), every op collapsing
    through the fused reducers."""
    a, v = _sym_input(64, seed=14)
    an = np.asarray(a, np.float64)
    e = v + st.transpose(v)
    en = an + an.T
    assert np.isclose(float(e.sum()), en.sum(), rtol=1e-4)
    assert np.isclose(float(e.max()), en.max())
    assert np.isclose(float(e.min()), en.min())
    assert np.isclose(float(e.mean()), en.mean(), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(st.to_array(e.sum(axis=0))).ravel(), en.sum(0), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(st.to_array(v.min(axis=1))).ravel(), an.min(1), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st.to_array(v.mean(axis=0))).ravel(), an.mean(0), rtol=1e-5
    )
    # prod on a small slice (value-scale safe), via the method surface
    s = st.strided(a[:5, :5])
    np.testing.assert_allclose(
        np.asarray(st.to_array(s.prod(axis=1))).ravel(),
        an[:5, :5].prod(1), rtol=1e-5,
    )
    # abs-expr reduction: map fuses into the reduce pass
    assert np.isclose(float(abs(v).max()), np.abs(an).max())


def test_matmul_operator():
    """``@`` on views and expressions lowers to linalg.matmul."""
    a, v = _sym_input(48, seed=15)
    b, w = _sym_input(48, seed=16)
    an, bn = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(
        np.asarray(st.to_array(v @ w)), an @ bn, rtol=1e-4, atol=1e-4
    )
    # expression operand collapses first, then multiplies
    np.testing.assert_allclose(
        np.asarray(st.to_array((v + v) @ w)), 2 * an @ bn, rtol=1e-4, atol=1e-4
    )
    # raw array right operand
    np.testing.assert_allclose(
        np.asarray(st.to_array(v @ b)), an @ bn, rtol=1e-4, atol=1e-4
    )


def test_pair_dispatch_routes_fuzz():
    """Route-matrix fuzz: random spellings across the three
    dispatch routes — same-buffer two-term -> pair-kernel, distinct two-term
    -> xla-pair, single transposed term / plain -> generic — each compared
    against its dispatch-off evaluation on the SAME expression builder.
    Pins that (a) the route taken matches the policy, (b) values agree
    across dispatch on/off for every spelling."""
    import random

    from strided_tpu.config import set_config, get_config

    rnd = random.Random(55)
    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024,
                   use_pallas=True)
        for trial in range(12):
            n = rnd.choice([137, 200, 256, 300])
            c1 = rnd.choice([1.0, -1.0, 2.5, 3.0])
            c2 = rnd.choice([1.0, -1.0, 0.5, 2.0])
            ep = rnd.choice([None, ("mul", 0.5), ("div", 4.0)])
            kind = rnd.choice(["same", "distinct", "single", "plain"])
            a = jnp.asarray(
                np.random.default_rng(trial).standard_normal((n, n)),
                jnp.float32,
            )
            b = jnp.asarray(
                np.random.default_rng(100 + trial).standard_normal((n, n)),
                jnp.float32,
            )

            def build():
                v = st.strided(a)
                w = st.strided(b)
                if kind == "same":
                    e = c1 * v + c2 * st.transpose(v)
                elif kind == "distinct":
                    e = c1 * v + c2 * st.transpose(w)
                elif kind == "single":
                    e = c1 * st.transpose(v)
                else:
                    e = c1 * v
                if ep is not None:
                    e = e * ep[1] if ep[0] == "mul" else e / ep[1]
                return e

            le.LAST_EXPR_DISPATCH = ""
            got = np.asarray(build().materialize())
            route = le.LAST_EXPR_DISPATCH
            want_route = {
                "same": "pair-kernel",
                "distinct": "xla-pair",
                "single": "generic",
                "plain": "generic",
            }[kind]
            assert route == want_route, (trial, kind, n, route)
            set_config(expr_pattern_dispatch=False)
            try:
                ref = np.asarray(build().materialize())
            finally:
                set_config(expr_pattern_dispatch=True)
            np.testing.assert_allclose(got, ref, rtol=3e-7, atol=3e-6,
                                       err_msg=f"{trial} {kind} {n}")
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_numpy_scalar_left_multiply_stays_lazy():
    """`np.float64(3) * v` must build a lazy expression, NOT hand the view
    to numpy's ufunc machinery (which would materialize it host-side via
    __array__ — a full device->host fetch). Pinned by __array_ufunc__=None."""
    v = st.strided(jnp.ones((8, 8), jnp.float32))
    e = np.float64(3.0) * v
    assert isinstance(e, StridedExpr)
    e2 = np.float32(2.0) + st.transpose(v)
    assert isinstance(e2, StridedExpr)
    # explicit conversion still works
    np.testing.assert_allclose(np.asarray(v), np.ones((8, 8)))


def test_pair_kernel_zero_beta_keeps_inf_nan_semantics():
    """`2*v + 0*v.T` must compute 0*inf = NaN exactly like the generic
    path — a zero coefficient in a TWO-term source never drops the term
    (a beta==0 shortcut would break this)."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    try:
        set_config(pair_kernel_min_elements=1024,
                   use_pallas=True)
        a = np.random.default_rng(0).standard_normal((256, 256)).astype(np.float32)
        a[3, 7] = np.inf
        aj = jnp.asarray(a)
        v = st.strided(aj)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray((2.0 * v + 0.0 * st.transpose(v)).materialize())
        assert le.LAST_EXPR_DISPATCH == "pair-kernel"
        want = np.asarray(jax.jit(lambda x: 2.0 * x + 0.0 * x.T)(aj))
        # [7, 3] reads the transpose of the inf -> 0*inf = NaN on both paths
        assert np.isnan(got[7, 3]) and np.isnan(want[7, 3])
        np.testing.assert_array_equal(got, want)
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_reduction_method_names():
    assert StridedExpr.sum.__name__ == "sum"
    assert st.StridedView.mean.__name__ == "mean"


def test_axpy_shape_mismatch_raises_layout_error():
    """Broadcast-incompatible axpy operands keep raising StridedLayoutError
    (the pair route must not leak a bare ValueError from expr building)."""
    from strided_tpu.core.view import StridedLayoutError

    a = st.strided(jnp.ones((3, 4), jnp.float32))
    b = st.strided(jnp.ones((5, 6), jnp.float32))
    with pytest.raises(StridedLayoutError):
        st.axpy(2.0, st.transpose(a), b)


def test_production_gate_boundary():
    """The PRODUCTION pair-kernel gate (4000^2, from the H100 measurement in
    PERF.md — config.pair_kernel_min_elements) is exercised directly: the
    shared eligibility predicate accepts 4000^2 and declines 3999^2, and
    the expression dispatch keeps 2048^2 on the generic path with correct
    values. (Running the kernel at 4000^2 in interpret mode is too slow
    for the CPU suite; chip_smoke.py runs it compiled on the GPU.)"""
    import os

    from strided_tpu.config import get_config
    from strided_tpu.core.kernels_special import pair_kernel_tile

    if os.environ.get("STRIDED_TPU_TEST_PROFILE", "default") != "default":
        pytest.skip("production-gate values apply in the default profile only")
    assert get_config().pair_kernel_min_elements == 4000 * 4000
    f32 = np.dtype("float32")
    assert pair_kernel_tile(4000, 4000, f32) is not None
    assert pair_kernel_tile(3999, 3999, f32) is None
    a, v = _sym_input(2048, seed=77)
    le.LAST_EXPR_DISPATCH = ""
    got = ((v + st.transpose(v)) / 2).evaluate()
    assert le.LAST_EXPR_DISPATCH == "generic"
    an = np.asarray(a, np.float64)
    np.testing.assert_allclose(
        np.asarray(got.parent).reshape(2048, 2048), (an + an.T) / 2,
        rtol=1e-6, atol=1e-6,
    )
    b, w = _sym_input(1024, seed=78)
    le.LAST_EXPR_DISPATCH = ""
    got = ((w + st.transpose(w)) / 2).evaluate()
    assert le.LAST_EXPR_DISPATCH == "generic"
