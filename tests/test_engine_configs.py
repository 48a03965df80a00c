"""Multi-config engine pass — the analog of the reference running its whole
suite once serial and once multithreaded (`/root/reference/test/runtests.jl:10-24`):
the same value-level assertions run with the hand-written kernels engaged at
every size (interpret mode on CPU), with them off, and with the dot_general
matmul dispatch off, and all must agree with the oracle bit-for-bit where
exact."""

import numpy as np
import pytest
import jax.numpy as jnp

import strided_tpu as st
from strided_tpu import config as cfg
from strided_tpu.core.mapreduce import (
    smap,
    copy_into,
    permutedims_into,
    sreduce,
    sreduce_dims,
    mapreducedim_into,
)
from strided_tpu.core.broadcast import sbroadcast, sbroadcast_into
from strided_tpu.core.regularize import materialize


ENGINE_CONFIGS = {
    "pallas": dict(use_pallas=True, pair_kernel_min_elements=1),
    "xla": dict(use_pallas=False),
    "nomxu": dict(use_mxu=False),
}


@pytest.fixture(params=sorted(ENGINE_CONFIGS))
def engine(request):
    old = cfg.get_config()
    cfg.set_config(**ENGINE_CONFIGS[request.param])
    yield request.param
    cfg.set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def rand32(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_symmetrize_both_paths(engine):
    a = rand32((128, 128))
    A = st.strided(jnp.asarray(a))
    B = st.strided(jnp.zeros((128, 128), jnp.float32))
    res = sbroadcast_into(B, lambda x, y: (x + y) / 2, A, st.transpose(A))
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(128, 128), (a + a.T) / 2, rtol=1e-6
    )


def test_symmetrize_expression_both_paths(engine):
    """The lazy flagship spelling: the tile-pair kernel under ``pallas``,
    XLA's fused expression otherwise — bit-identical either way."""
    a = rand32((192, 192), seed=8)
    v = st.strided(jnp.asarray(a))
    got = np.asarray(((v + st.transpose(v)) / 2).materialize())
    np.testing.assert_array_equal(got, (a + a.T) / np.float32(2))


def test_permute_copy_both_paths(engine):
    t = rand32((8, 16, 8, 16), seed=1)
    out = st.strided(jnp.zeros((16, 8, 16, 8), jnp.float32))
    res = permutedims_into(out, jnp.asarray(t), (3, 2, 1, 0))
    np.testing.assert_array_equal(
        np.asarray(res.parent).reshape(16, 8, 16, 8), np.transpose(t, (3, 2, 1, 0))
    )


def test_fused_4permute_sum_both_paths(engine):
    t = rand32((8, 8, 8, 8), seed=2)
    T = st.strided(jnp.asarray(t))
    perms = [(0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2)]
    res = sbroadcast(lambda a, b, c, d: a + b + c + d, *[st.permutedims(T, p) for p in perms])
    expect = sum(np.transpose(t, p) for p in perms)
    np.testing.assert_allclose(np.asarray(materialize(res)), expect, rtol=1e-5)


def test_reduction_beta_both_paths(engine):
    beta = 2.5
    a = rand32((32, 256), seed=3)
    c0 = rand32((32, 1), seed=4)
    out = st.broadcast_to(st.strided(jnp.asarray(c0.copy())), (32, 256))
    res = mapreducedim_into(
        lambda x: x * x, jnp.add, lambda z: beta * z, out, st.strided(jnp.asarray(a))
    )
    expect = beta * c0 + (a * a).sum(axis=1, keepdims=True)
    np.testing.assert_allclose(
        np.asarray(res.parent).reshape(32, 1), expect, rtol=2e-5
    )


def test_complete_sum_both_paths(engine):
    a = rand32((64, 64), seed=5)
    got = sreduce(lambda x: x, jnp.add, st.transpose(st.strided(jnp.asarray(a))))
    np.testing.assert_allclose(float(got), a.sum(), rtol=1e-4)


def test_sum_dims_both_paths(engine):
    a = rand32((16, 32, 16), seed=6)
    res = sreduce_dims(lambda x: x, jnp.add, st.strided(jnp.asarray(a)), (1,))
    np.testing.assert_allclose(
        np.asarray(materialize(res)), a.sum(axis=1, keepdims=True), rtol=1e-5
    )


def test_int_exact_both_paths(engine):
    a = np.random.default_rng(7).integers(-50, 50, (64, 64)).astype(np.int32)
    A = st.strided(jnp.asarray(a))
    res = smap(lambda x, y: x * y + x, A, st.transpose(A))
    np.testing.assert_array_equal(
        np.asarray(materialize(res)), a * a.T + a
    )
