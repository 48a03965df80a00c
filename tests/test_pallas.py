"""Tile-pair kernel and platform-gate tests.

On the CPU the kernel runs in Pallas interpret mode (``conftest.py`` sets
``Config.interpret``) through the same Triton-route ``pallas_call`` the GPU
compiles; every case is compared with the plain fused XLA expression or
numpy. Tests marked ``gpu`` run the compiled kernel and skip without a card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import strided_tpu as st
from strided_tpu import config as cfg
from strided_tpu.core import lazy_expr as le
from strided_tpu.core.kernels_special import pair_axpby, pair_kernel_tile, symmetrize


@pytest.fixture
def kernels_on():
    """Kernel path engaged at every size (the suite-wide profile may lower
    or raise the gate)."""
    old = cfg.get_config()
    cfg.set_config(use_pallas=True, pair_kernel_min_elements=1)
    yield
    cfg.set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def _rand(n, seed, dtype=np.float32):
    return jnp.asarray(np.random.default_rng(seed).standard_normal((n, n)), dtype)


def test_engine_dispatch_consistency():
    """fused_mapreduce must give identical results whether or not the kernel
    paths are enabled (the reference's 1-thread vs N-thread equivalence)."""
    a = np.random.default_rng(10).standard_normal((128, 512)).astype(np.float32)
    A = st.strided(jnp.asarray(a))

    def run():
        B = st.strided(jnp.zeros((512, 128), jnp.float32))
        return np.asarray(
            st.sbroadcast_into(B, lambda x: x * 3, st.transpose(A)).parent
        )

    old = cfg.get_config()
    try:
        cfg.set_config(use_pallas=True)
        with_kernels = run()
        cfg.set_config(use_pallas=False)
        without = run()
    finally:
        cfg.set_config(use_pallas=old.use_pallas)
    np.testing.assert_allclose(with_kernels, without, rtol=1e-6)


def test_symmetrize_special_kernel(kernels_on):
    a = _rand(1024, 20)
    r = np.asarray(symmetrize(a, tile=128))
    an = np.asarray(a)
    np.testing.assert_allclose(r, (an + an.T) / 2, rtol=1e-6)
    # odd sizes take the kernel with masked edge tiles
    b = _rand(100, 21)
    np.testing.assert_allclose(
        np.asarray(symmetrize(b)), (np.asarray(b) + np.asarray(b).T) / 2, rtol=1e-6
    )
    # f64 falls back to the fused expression
    c = _rand(64, 22, np.float64)
    assert pair_kernel_tile(64, 64, c.dtype) is None
    np.testing.assert_array_equal(
        np.asarray(symmetrize(c)), (np.asarray(c) + np.asarray(c).T) * 0.5
    )


@pytest.mark.parametrize("n", [1000, 392])
def test_pair_kernel_clamped_bit_exact_vs_strips(n, kernels_on):
    """Ragged sizes (n not a multiple of the tile): masked edge tiles must
    write exactly what the identical-structure fused XLA expression writes,
    for the same-buffer, distinct-buffer and single-transposed-term
    families."""
    rng = np.random.default_rng(n)
    a = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    c = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    # same-buffer symmetrize (alpha == beta: S2 = S1.T shortcut in play)
    got = np.asarray(pair_axpby(a, scale_mode="div", scale=2.0))
    want = np.asarray(jax.jit(lambda x: (x + x.T) / 2.0)(a))
    np.testing.assert_array_equal(got, want)
    # same-buffer axpby-transpose (alpha != beta): the coeff-mul + add
    # structure gives the compiler an FMA-contraction choice, which can
    # differ between separately compiled programs by 1 ulp — pin to a
    # few-ulp bound
    got = np.asarray(pair_axpby(a, alpha=3.0, beta=2.0))
    want = np.asarray(jax.jit(lambda x: 3.0 * x + 2.0 * x.T)(a))
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    # distinct buffers
    got = np.asarray(pair_axpby(a, c, alpha=1.0, beta=-1.0))
    want = np.asarray(jax.jit(lambda x, y: x + -(y.T))(a, c))
    np.testing.assert_array_equal(got, want)
    # single-transposed-term (alpha == 0 drops the plain term)
    got = np.asarray(pair_axpby(a, alpha=0.0, beta=3.0))
    want = np.asarray(jax.jit(lambda x: x.T * 3.0)(a))
    np.testing.assert_array_equal(got, want)


# Every spelling of the same-buffer family the expression dispatch matches
# (lazy_expr._match_pair), with its plain-XLA twin and whether the spelling
# leaves an FMA-contraction choice (then a few-ulp bound, else exact).
SPELLINGS = {
    "sym_div": (lambda v: (v + st.transpose(v)) / 2, lambda x: (x + x.T) / 2, False),
    "sym_mul_right": (lambda v: (st.transpose(v) + v) * 0.5, lambda x: (x.T + x) * 0.5, False),
    "sym_mul_left": (lambda v: 0.5 * (v + st.transpose(v)), lambda x: 0.5 * (x + x.T), False),
    "antisym": (lambda v: v - st.transpose(v), lambda x: x - x.T, False),
    "neg_first": (lambda v: -st.transpose(v) + v, lambda x: -x.T + x, False),
    "axpby": (lambda v: 3 * v + 2 * st.transpose(v), lambda x: 3 * x + 2 * x.T, True),
}


@pytest.mark.parametrize("spelling", sorted(SPELLINGS))
@pytest.mark.parametrize("n", [128, 392, 1000])
def test_pair_kernel_expression_spellings(n, spelling, kernels_on):
    lazy, plain, fma = SPELLINGS[spelling]
    a = _rand(n, n + 7)
    le.LAST_EXPR_DISPATCH = ""
    got = np.asarray(lazy(st.strided(a)).materialize())
    assert le.LAST_EXPR_DISPATCH == "pair-kernel", spelling
    want = np.asarray(jax.jit(plain)(a))
    if fma:
        np.testing.assert_allclose(got, want, rtol=0, atol=8e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 17, 63, 64, 65, 200])
def test_pair_kernel_edge_masks(n, kernels_on):
    """Sizes below, at and just past one 64-wide tile: masked loads and
    stores must neither read nor write outside the matrix."""
    a = _rand(n, 3 * n)
    an = np.asarray(a)
    got = np.asarray(pair_axpby(a, alpha=1.0, beta=-1.0, tile=64))
    np.testing.assert_array_equal(got, an - an.T)


def test_pair_kernel_bf16(kernels_on):
    a = jnp.asarray(np.random.default_rng(5).standard_normal((160, 160)), jnp.bfloat16)
    got = np.asarray(symmetrize(a, tile=32), np.float32)
    want = np.asarray(jax.jit(lambda x: (x + x.T) * 0.5)(a), np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", [0, 8, 48, 100])
def test_pair_kernel_tile_must_be_power_of_two(tile, kernels_on):
    with pytest.raises(ValueError):
        pair_axpby(_rand(64, 1), tile=tile)


def test_pair_kernel_gate_declines_below_threshold():
    old = cfg.get_config()
    try:
        cfg.set_config(pair_kernel_min_elements=1 << 20)
        assert pair_kernel_tile(512, 512, np.dtype("float32")) is None
        assert pair_kernel_tile(1024, 1024, np.dtype("float32")) is not None
        assert pair_kernel_tile(1024, 512, np.dtype("float32")) is None
    finally:
        cfg.set_config(pair_kernel_min_elements=old.pair_kernel_min_elements)


# ---- the platform gate (config.kernel_mode) --------------------------------


@pytest.mark.parametrize(
    "platform, interpret, use_pallas, expected",
    [
        ("cpu", False, True, None),
        ("cpu", True, True, "interpret"),
        ("cpu", True, False, None),
        ("gpu", False, True, "triton"),
        ("gpu", False, False, None),
        ("rocm", True, True, None),
    ],
)
def test_kernel_mode(monkeypatch, platform, interpret, use_pallas, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    old = cfg.get_config()
    try:
        cfg.set_config(interpret=interpret, use_pallas=use_pallas)
        assert cfg.kernel_mode() == expected
    finally:
        cfg.set_config(interpret=old.interpret, use_pallas=old.use_pallas)


def test_kernel_mode_refuses_interpret_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    old = cfg.get_config()
    try:
        cfg.set_config(interpret=True)
        with pytest.raises(RuntimeError, match="interpret"):
            cfg.kernel_mode()
        with pytest.raises(RuntimeError, match="interpret"):
            symmetrize(_rand(64, 2), tile=64)
    finally:
        cfg.set_config(interpret=old.interpret)


def test_no_kernel_without_interpret_on_cpu():
    """On the CPU without ``interpret`` no kernel is offered: the pair
    dispatch declines and the fused expression runs."""
    old = cfg.get_config()
    try:
        cfg.set_config(interpret=False, pair_kernel_min_elements=1)
        assert pair_kernel_tile(256, 256, np.dtype("float32")) is None
        a = _rand(256, 4)
        v = st.strided(a)
        le.LAST_EXPR_DISPATCH = ""
        got = np.asarray(((v + st.transpose(v)) / 2).materialize())
        assert le.LAST_EXPR_DISPATCH == "generic"
        np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda x: (x + x.T) / 2)(a)))
    finally:
        cfg.set_config(interpret=old.interpret,
                       pair_kernel_min_elements=old.pair_kernel_min_elements)


# ---- compile-cache path rule ------------------------------------------------


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from strided_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else is set


def test_compile_cache_fixed_repo_path(monkeypatch):
    import os

    from strided_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    gitignore = open(os.path.join(repo, ".gitignore")).read().split()
    assert ".jax_cache/" in gitignore


# ---- compiled on the card ---------------------------------------------------


@pytest.mark.gpu
def test_pair_kernel_flagship_4000_bit_exact(gpu):
    """The reference's literal 4000^2 flagship size through the compiled
    kernel, bit-exact against XLA's fused expression."""
    rng = np.random.default_rng(40)
    a = jnp.asarray(rng.standard_normal((4000, 4000)), jnp.float32)
    got = np.asarray(pair_axpby(a, scale_mode="div", scale=2.0, tile=64))
    want = np.asarray(jax.jit(lambda x: (x + x.T) / 2.0)(a))
    np.testing.assert_array_equal(got, want)
