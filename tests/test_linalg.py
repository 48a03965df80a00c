"""Linalg tests — the op-grid and eltype-promotion matmul contract of
`/root/reference/test/blasmultests.jl` and the exact-arithmetic generic-path
grid of `/root/reference/test/othertests.jl:253-333`, adapted: ints play the
role of Complex{Int}/Rational (exact dtypes forcing the generic engine path).
Odd size 103 intentionally avoids tile-friendly shapes (blasmultests.jl:4)."""

import numpy as np
import pytest
import jax.numpy as jnp

import strided_tpu as st
from strided_tpu.linalg import mul, matmul, axpy, axpby, lmul, rmul
from strided_tpu.core.regularize import materialize
from strided_tpu import config as cfg


def rand(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-10, 10, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def make_op(x, opname):
    """Build (lazy_view, dense_oracle) applying one of the 4 ops."""
    v = st.strided(jnp.asarray(x))
    if opname == "identity":
        return v, x
    if opname == "conj":
        return st.conj(v), np.conj(x)
    if opname == "transpose":
        return st.transpose(v), x.T
    if opname == "adjoint":
        return st.adjoint(v), np.conj(x.T)
    raise AssertionError


OPS = ["identity", "conj", "transpose", "adjoint"]


@pytest.mark.parametrize("op1", OPS)
@pytest.mark.parametrize("op2", OPS)
def test_generic_mul_int_exact_grid(op1, op2):
    """Exact arithmetic op^2 grid on int64 — any indexing/initop error shows
    exactly (othertests.jl:253-297)."""
    d = 7
    a = rand((d, d), np.int64, 1)
    b = rand((d, d), np.int64, 2)
    c = rand((d, d), np.int64, 3)
    A, oa = make_op(a, op1)
    B, ob = make_op(b, op2)
    C = st.strided(jnp.asarray(c.copy()))
    res = mul(C, A, B, alpha=3, beta=2)
    expect = 3 * (oa @ ob) + 2 * c
    np.testing.assert_array_equal(np.asarray(materialize(res)), expect)


def make_dst(c, opname):
    """Destination view op3(C): allocate the parent so the LOGICAL shape of
    the view equals c.shape; returns (view, dense_oracle_of_view)."""
    if opname == "identity":
        return st.strided(jnp.asarray(c.copy())), c
    if opname == "conj":
        return st.conj(st.strided(jnp.asarray(np.conj(c)))), c
    if opname == "transpose":
        return st.transpose(st.strided(jnp.asarray(c.T.copy()))), c
    if opname == "adjoint":
        return st.adjoint(st.strided(jnp.asarray(np.conj(c.T)))), c
    raise AssertionError


@pytest.mark.parametrize("op3", OPS)
@pytest.mark.parametrize("op2", OPS)
@pytest.mark.parametrize("op1", OPS)
def test_generic_mul_complexint_op3_grid(op1, op2, op3):
    """FULL op^3 grid including the destination C, exact complex-integer
    arithmetic (the Complex{Int} analog: complex128 holding small ints is
    exact in f64), generic engine path forced — the contract of
    `/root/reference/test/othertests.jl:253-297` incl. write-inversion
    through conj/transpose/adjoint destinations."""
    d, e = 5, 7  # non-square: catches transposed-shape mixups
    rng = np.random.default_rng(11)

    def cint(shape):
        return (
            rng.integers(-5, 5, size=shape) + 1j * rng.integers(-5, 5, size=shape)
        ).astype(np.complex128)

    # operand shapes chosen so the op'd views have shapes (d,e) @ (e,d)
    a = cint((d, e) if op1 in ("identity", "conj") else (e, d))
    b = cint((e, d) if op2 in ("identity", "conj") else (d, e))
    c = cint((d, d))
    alpha, beta = 2 - 1j, 1 + 3j  # exact complex-int scalars
    A, oa = make_op(a, op1)
    B, ob = make_op(b, op2)
    C, oc = make_dst(c, op3)
    cfg.disable_mxu()
    try:
        res = mul(C, A, B, alpha=alpha, beta=beta)
    finally:
        cfg.enable_mxu()
    expect = alpha * (oa @ ob) + beta * oc
    np.testing.assert_array_equal(np.asarray(materialize(res)), expect)


@pytest.mark.parametrize("op3", OPS)
@pytest.mark.parametrize("op2", OPS)
@pytest.mark.parametrize("op1", OPS)
def test_generic_mul_int_op3_grid(op1, op2, op3):
    """op^3 grid on int64 (exact, generic path by dtype) — the Rational-grid
    analog (`/root/reference/test/othertests.jl:299-333`)."""
    d, e = 4, 6
    a = rand((d, e) if op1 in ("identity", "conj") else (e, d), np.int64, 21)
    b = rand((e, d) if op2 in ("identity", "conj") else (d, e), np.int64, 22)
    c = rand((d, d), np.int64, 23)
    A, oa = make_op(a, op1)
    B, ob = make_op(b, op2)
    C, oc = make_dst(c, op3)
    res = mul(C, A, B, alpha=3, beta=-2)
    expect = 3 * (oa @ ob) - 2 * oc
    np.testing.assert_array_equal(np.asarray(materialize(res)), expect)


BLAS_DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


@pytest.mark.parametrize("dt1", BLAS_DTYPES)
@pytest.mark.parametrize("dt2", BLAS_DTYPES)
def test_blasfloat_op3_grid(dt1, dt2):
    """The reference's blasmultests contract: 4x4 eltype grid x FULL op^3
    (destination included) with random alpha/beta
    (`/root/reference/test/blasmultests.jl:15-27`). Equal eltypes hit the
    MXU path, mixed force the generic engine; d=33 odd avoids tile-friendly
    shapes (blasmultests.jl:4). All 64 op combos run inside each dtype pair,
    mirroring the Julia loop structure."""
    d, e = 33, 21
    rng = np.random.default_rng(hash((str(dt1), str(dt2))) % 2**31)
    cd = np.promote_types(dt1, dt2)
    tol = 1e-4 if np.dtype(cd).itemsize <= 8 else 1e-10

    def scal(dtype):
        x = rng.standard_normal()
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal()
        return complex(x) if np.issubdtype(dtype, np.complexfloating) else float(x)

    for op1 in OPS:
        for op2 in OPS:
            for op3 in OPS:
                a = rand((d, e) if op1 in ("identity", "conj") else (e, d), dt1,
                         int(rng.integers(0, 2**31)))
                b = rand((e, d) if op2 in ("identity", "conj") else (d, e), dt2,
                         int(rng.integers(0, 2**31)))
                c = rand((d, d), cd, int(rng.integers(0, 2**31)))
                alpha, beta = scal(cd), scal(cd)
                A, oa = make_op(a, op1)
                B, ob = make_op(b, op2)
                C, oc = make_dst(c, op3)
                res = mul(C, A, B, alpha=alpha, beta=beta)
                expect = alpha * (oa.astype(cd) @ ob.astype(cd)) + beta * oc
                np.testing.assert_allclose(
                    np.asarray(materialize(res)), expect, rtol=tol, atol=tol,
                    err_msg=f"ops=({op1},{op2},{op3}) dtypes=({dt1},{dt2})",
                )


@pytest.mark.parametrize("dt1", [np.float32, np.float64, np.complex64, np.complex128])
@pytest.mark.parametrize("dt2", [np.float64, np.complex128])
def test_eltype_promotion_grid(dt1, dt2):
    """Mixed eltypes force the generic path; equal hit the MXU path
    (blasmultests.jl:1-28)."""
    d = 103
    rng = np.random.default_rng(5)
    alpha, beta = rng.standard_normal(), rng.standard_normal()
    a = rand((d, d), dt1, 6)
    b = rand((d, d), dt2, 7)
    cd = np.promote_types(dt1, dt2)
    c = rand((d, d), cd, 8)
    A, oa = make_op(a, "transpose")
    B, ob = make_op(b, "adjoint" if np.issubdtype(dt2, np.complexfloating) else "identity")
    C = st.strided(jnp.asarray(c.copy()))
    res = mul(C, A, B, alpha=alpha, beta=beta)
    expect = alpha * (oa.astype(cd) @ ob.astype(cd)) + beta * c
    np.testing.assert_allclose(np.asarray(materialize(res)), expect, rtol=1e-5)


def test_outer_product():
    # k=1 (blasmultests.jl:30-56)
    a = rand((9, 1), np.float64, 1)
    b = rand((1, 11), np.float64, 2)
    res = matmul(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(materialize(res)), a @ b, rtol=1e-14)


def test_inner_product():
    # m=n=1 (blasmultests.jl:58-84)
    a = rand((1, 17), np.float64, 3)
    b = rand((17, 1), np.float64, 4)
    c = np.array([[2.0]])
    res = mul(st.strided(jnp.asarray(c.copy())), jnp.asarray(a), jnp.asarray(b),
              alpha=2.0, beta=3.0)
    np.testing.assert_allclose(
        np.asarray(materialize(res)), 2.0 * (a @ b) + 3.0 * c, rtol=1e-14
    )


def test_zero_inner_dim():
    # k=0: C = beta*C (blasmultests.jl:88-98)
    c = rand((5, 5), np.float64, 9)
    res = mul(st.strided(jnp.asarray(c.copy())), jnp.zeros((5, 0)), jnp.zeros((0, 5)),
              alpha=1.0, beta=2.0)
    np.testing.assert_allclose(np.asarray(materialize(res)), 2 * c, rtol=1e-14)


def test_zero_size_output():
    res = matmul(jnp.zeros((0, 4)), jnp.ones((4, 3)))
    assert res.shape == (0, 3)


@pytest.mark.parametrize("special", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_alpha_beta_specials(special):
    alpha, beta = special
    a = rand((8, 8), np.float64, 1)
    b = rand((8, 8), np.float64, 2)
    c = rand((8, 8), np.float64, 3)
    res = mul(st.strided(jnp.asarray(c.copy())), jnp.asarray(a), jnp.asarray(b),
              alpha=alpha, beta=beta)
    np.testing.assert_allclose(
        np.asarray(materialize(res)), alpha * (a @ b) + beta * c, rtol=1e-14
    )


def test_mul_into_conj_dst():
    """C.op == conj canonicalization (linalg.jl:50-62): writing through a
    conj view must store the conjugate."""
    a = rand((6, 6), np.complex128, 1)
    b = rand((6, 6), np.complex128, 2)
    c = rand((6, 6), np.complex128, 3)
    C = st.conj(st.strided(jnp.asarray(c.copy())))
    res = mul(C, jnp.asarray(a), jnp.asarray(b), alpha=1.0, beta=0.0)
    # logical result == a@b; the parent stores its conjugate
    np.testing.assert_allclose(np.asarray(materialize(res)), a @ b, rtol=1e-13)
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(6, 6), np.conj(a @ b), rtol=1e-13
    )


def test_mul_into_transposed_dst():
    a = rand((4, 6), np.float64, 1)
    b = rand((6, 5), np.float64, 2)
    cbuf = st.strided(jnp.zeros((5, 4)))
    C = st.transpose(cbuf)  # logical (4,5)
    res = mul(C, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(materialize(res)), a @ b, rtol=1e-14)
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(5, 4), (a @ b).T, rtol=1e-14
    )


def test_generic_forced_when_mxu_disabled():
    cfg.disable_mxu()
    try:
        a = rand((12, 12), np.float64, 1)
        b = rand((12, 12), np.float64, 2)
        res = matmul(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(materialize(res)), a @ b, rtol=1e-13)
    finally:
        cfg.enable_mxu()


def test_axpy_axpby_lmul_rmul():
    x = rand((7, 9), np.float64, 1)
    y = rand((7, 9), np.float64, 2)
    res = axpy(2.0, jnp.asarray(x), st.strided(jnp.asarray(y.copy())))
    np.testing.assert_allclose(np.asarray(materialize(res)), 2 * x + y, rtol=1e-14)
    res = axpby(2.0, jnp.asarray(x), 3.0, st.strided(jnp.asarray(y.copy())))
    np.testing.assert_allclose(np.asarray(materialize(res)), 2 * x + 3 * y, rtol=1e-14)
    res = lmul(0.5, st.strided(jnp.asarray(y.copy())))
    np.testing.assert_allclose(np.asarray(materialize(res)), 0.5 * y, rtol=1e-14)
    res = rmul(st.strided(jnp.asarray(y.copy())), 0.0)
    np.testing.assert_allclose(np.asarray(materialize(res)), 0 * y)


def test_axpy_over_permuted_views():
    # rank-4 lazy-permuted operands (othertests.jl:17-44 style)
    x = rand((3, 4, 5, 2), np.float64, 1)
    y = rand((5, 3, 2, 4), np.float64, 2)
    xv = st.permutedims(st.strided(jnp.asarray(x)), (2, 0, 3, 1))  # -> (5,3,2,4)
    res = axpy(1.5, xv, st.strided(jnp.asarray(y.copy())))
    np.testing.assert_allclose(
        np.asarray(materialize(res)), 1.5 * np.transpose(x, (2, 0, 3, 1)) + y,
        rtol=1e-14,
    )


def test_contract_einsum_over_views():
    # tensor contraction with lazy permuted operands vs numpy einsum
    from strided_tpu.linalg import contract
    a = rand((4, 5, 6), np.float64, 11)
    w = rand((5, 6, 7), np.float64, 12)
    av = st.permutedims(st.strided(jnp.asarray(a)), (0, 2, 1))  # (4,6,5)
    got = contract("acb,bcd->ad", av, jnp.asarray(w))
    expect = np.einsum("acb,bcd->ad", np.transpose(a, (0, 2, 1)), w)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-12)


def test_linalg_pair_kernel_routes():
    """The reference's LITERAL linalg spellings hit the tile-pair kernel:
    ``axpby!(alpha, A', beta, B)``
    (`/root/reference/src/linalg.jl:39-42`), ``axpy!(alpha, A', B)``
    (`:33-37`), and ``mul!(B, alpha, A')`` (`:22-31`) with a lazy-transposed
    square operand dispatch exactly like the expression spellings — pinned
    via LAST_EXPR_DISPATCH and checked against the identical XLA
    expression."""
    import jax
    from strided_tpu.core import lazy_expr as le

    old = cfg.get_config()
    try:
        cfg.set_config(pair_kernel_min_elements=1024, use_pallas=True)
        rng = np.random.default_rng(21)
        a = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
        b = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
        v = st.strided(a)

        # distinct buffers -> the fused-XLA pair route
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(st.to_array(axpby(3.0, st.transpose(v), 2.0, st.strided(b))))
        assert le.LAST_EXPR_DISPATCH == "xla-pair"
        np.testing.assert_array_equal(
            got, np.asarray(jax.jit(lambda x, y: 3.0 * x.T + 2.0 * y)(a, b))
        )

        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(st.to_array(axpy(3.0, st.transpose(v), st.strided(b))))
        assert le.LAST_EXPR_DISPATCH == "xla-pair"
        np.testing.assert_array_equal(
            got, np.asarray(jax.jit(lambda x, y: 3.0 * x.T + y)(a, b))
        )

        # scale_into (mul!(B, 3, A')): single-term family — stays on the
        # generic path (XLA's transpose emitter); values pinned.
        dst = st.strided(jnp.zeros((256, 256), jnp.float32))
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(st.to_array(st.scale_into(dst, 3.0, st.transpose(v))))
        assert le.LAST_EXPR_DISPATCH != "pair-kernel"
        np.testing.assert_allclose(
            got, np.asarray(jax.jit(lambda x: x.T * 3.0)(a)), rtol=1e-6
        )

        # same-buffer spelling: axpby!(3, A', 2, A) — the tile-pair kernel;
        # a separately compiled program, so its FMA contraction may move
        # the last ulp (see test_lazy_expr::test_pair_term_order_bit_exact)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(st.to_array(axpby(3.0, st.transpose(v), 2.0, v)))
        assert le.LAST_EXPR_DISPATCH == "pair-kernel"
        want = np.asarray(jax.jit(lambda x: 3.0 * x.T + 2.0 * x)(a))
        an = np.asarray(a)
        assert (np.abs(got - want) <= 2 * np.spacing(3 * np.abs(an.T) + 2 * np.abs(an))).all()
    finally:
        cfg.set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_linalg_pair_route_fallbacks_unchanged():
    """Non-matching layouts (rectangular, non-transposed, dynamic scalars)
    keep the generic fused-broadcast behavior exactly as before."""
    from strided_tpu.core import lazy_expr as le

    old = cfg.get_config()
    try:
        cfg.set_config(pair_kernel_min_elements=1024, use_pallas=True)
        rng = np.random.default_rng(22)
        a = jnp.asarray(rng.standard_normal((64, 96)), jnp.float32)
        b = jnp.asarray(rng.standard_normal((96, 64)), jnp.float32)
        # rectangular transposed operand: generic path, correct values
        got = np.asarray(st.to_array(axpby(3.0, st.transpose(st.strided(a)), 2.0, st.strided(b))))
        np.testing.assert_allclose(
            got, 3.0 * np.asarray(a).T + 2.0 * np.asarray(b),
            rtol=1e-5, atol=1e-5,
        )
        # non-transposed square operand: generic
        sq = jnp.asarray(rng.standard_normal((64, 64)), jnp.float32)
        sq2 = jnp.asarray(rng.standard_normal((64, 64)), jnp.float32)
        got = np.asarray(st.to_array(axpby(3.0, st.strided(sq), 2.0, st.strided(sq2))))
        np.testing.assert_allclose(
            got, 3.0 * np.asarray(sq) + 2.0 * np.asarray(sq2),
            rtol=1e-5, atol=1e-5,
        )
        # traced (non-static) scalar: generic, still correct
        import jax

        @jax.jit
        def f(alpha, x, y):
            return st.to_array(axpby(alpha, st.transpose(st.strided(x)), 2.0, st.strided(y)))

        sqT = jnp.asarray(rng.standard_normal((64, 64)), jnp.float32)
        got = np.asarray(f(jnp.float32(3.0), sqT, sq2))
        np.testing.assert_allclose(
            got, 3.0 * np.asarray(sqT).T + 2.0 * np.asarray(sq2),
            rtol=1e-5, atol=1e-5,
        )
    finally:
        cfg.set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})
