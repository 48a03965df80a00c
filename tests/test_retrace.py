"""No-retrace contracts for engine entry points — the jit analog of the reference's ``@inferred`` type-
stability assertions (`/root/reference/test/othertests.jl:46-66`):

A :class:`StridedView` is a pytree whose layout metadata (shape/strides/
offset/conj) is static aux data, so a jitted engine call must (a) NOT
retrace when called again with identical layouts and fresh data, and
(b) retrace exactly once when the layout changes. This pins that planner
decisions are pure functions of static metadata (SURVEY §7: "planner must
be hashable/cacheable to avoid recompiles")."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import strided_tpu as st
from strided_tpu.core.mapreduce import map_into, sreduce_dims, sreduce
from strided_tpu.linalg import mul


def _views(seed, transpose_in=False):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((32, 64)), jnp.float32)
    v = st.strided(a)
    if transpose_in:
        v = st.transpose(st.strided(jnp.asarray(rng.standard_normal((64, 32)),
                                                jnp.float32)))
    out = st.strided(jnp.zeros((32, 64), jnp.float32))
    return out, v


def test_map_into_no_retrace():
    traces = []

    @jax.jit
    def f(out, v):
        traces.append(1)
        return map_into(out, lambda x: 2 * x, v)

    out1, v1 = _views(0)
    out2, v2 = _views(1)
    r1 = f(out1, v1)
    r2 = f(out2, v2)  # same layouts, fresh data: cache hit
    assert len(traces) == 1, "map_into retraced under identical static metadata"
    np.testing.assert_allclose(
        np.asarray(r2.parent), 2 * np.asarray(v2.parent), rtol=1e-6
    )
    # different layout (transposed input): exactly one more trace
    out3, v3 = _views(2, transpose_in=True)
    f(out3, v3)
    assert len(traces) == 2, "layout change must retrace (static aux data)"
    f(*_views(3, transpose_in=True))
    assert len(traces) == 2


def test_sreduce_dims_no_retrace():
    traces = []

    @jax.jit
    def f(v):
        traces.append(1)
        return sreduce_dims(lambda x: x * x, jnp.add, v, (1,))

    _, v1 = _views(4)
    _, v2 = _views(5)
    r1 = f(v1)
    r2 = f(v2)
    assert len(traces) == 1, "sreduce_dims retraced under identical metadata"
    np.testing.assert_allclose(
        np.asarray(r2.parent).reshape(32, 1),
        (np.asarray(v2.parent).reshape(32, 64) ** 2).sum(1, keepdims=True),
        rtol=1e-5,
    )
    f(st.transpose(v1))
    assert len(traces) == 2


def test_complete_reduce_no_retrace():
    traces = []

    @jax.jit
    def f(v):
        traces.append(1)
        return sreduce(lambda x: x, jnp.add, v)

    _, v1 = _views(6)
    _, v2 = _views(7)
    f(v1)
    f(v2)
    assert len(traces) == 1


def test_mul_no_retrace():
    traces = []

    @jax.jit
    def f(C, A, B):
        traces.append(1)
        return mul(C, A, B, alpha=2.0, beta=0.5)

    rng = np.random.default_rng(8)

    def mk():
        A = st.strided(jnp.asarray(rng.standard_normal((16, 24)), jnp.float32))
        B = st.strided(jnp.asarray(rng.standard_normal((24, 20)), jnp.float32))
        C = st.strided(jnp.asarray(rng.standard_normal((16, 20)), jnp.float32))
        return C, A, B

    C1, A1, B1 = mk()
    C2, A2, B2 = mk()
    f(C1, A1, B1)
    r = f(C2, A2, B2)
    assert len(traces) == 1, "mul retraced under identical static metadata"
    want = 2.0 * np.asarray(A2.parent).reshape(16, 24) @ np.asarray(
        B2.parent
    ).reshape(24, 20) + 0.5 * np.asarray(C2.parent).reshape(16, 20)
    np.testing.assert_allclose(np.asarray(r.parent).reshape(16, 20), want, rtol=1e-5)
    # transposed A (lazy op flip) is a different static layout: one retrace
    At = st.transpose(st.strided(jnp.asarray(rng.standard_normal((24, 16)),
                                             jnp.float32)))
    f(C1, At, B1)
    assert len(traces) == 2


def test_pair_pattern_dispatch_no_retrace():
    """The pair-kernel pattern dispatch under jit: same layouts -> cache
    hit; same function works eagerly too (trace-time dispatch is a pure
    function of static metadata + config)."""
    from strided_tpu.config import set_config, get_config

    old = get_config()
    traces = []
    try:
        set_config(pair_kernel_min_elements=1024, use_pallas=True)

        @jax.jit
        def f(x):
            traces.append(1)
            v = st.strided(x)
            return st.to_array((v + st.transpose(v)) / 2)

        rng = np.random.default_rng(5)
        a = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
        b = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
        r1 = f(a)
        r2 = f(b)
        assert len(traces) == 1, "pattern dispatch retraced on fresh data"
        np.testing.assert_allclose(
            np.asarray(r2), (np.asarray(b) + np.asarray(b).T) / 2, rtol=1e-6
        )
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_stream_reduce_dispatch_no_retrace():
    from strided_tpu.config import set_config, get_config

    old = get_config()
    traces = []
    try:
        @jax.jit
        def f(x):
            traces.append(1)
            return sreduce_dims(lambda v: v, jnp.add, st.strided(x), (0,)).parent

        rng = np.random.default_rng(6)
        a = jnp.asarray(rng.standard_normal((512, 256)), jnp.float32)
        b = jnp.asarray(rng.standard_normal((512, 256)), jnp.float32)
        f(a)
        r2 = f(b)
        assert len(traces) == 1, "leading-axis reduction retraced on fresh data"
        np.testing.assert_allclose(
            np.asarray(r2).reshape(256), np.asarray(b).sum(0), rtol=1e-4,
            atol=1e-4
        )
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})
