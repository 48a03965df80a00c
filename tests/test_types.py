"""Result-type contract of the broadcast/map surface — the analog of the
reference's type-behavior assertions (`/root/reference/test/othertests.jl:38-39,
61-64` and the style-precedence rules of `/root/reference/src/broadcast.jl:3-6`):
all-strided operations stay in the lazy/strided world; explicit conversion
points (`to_array`, `maybe_unstrided`, `strided_jit` returns) produce dense
arrays."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import strided_tpu as st
from strided_tpu.core.view import StridedView
from strided_tpu.core.lazy_expr import StridedExpr


@pytest.fixture
def av():
    a = np.random.default_rng(0).standard_normal((6, 8))
    return a, st.strided(jnp.asarray(a))


def test_smap_all_views_returns_view(av):
    a, v = av
    out = st.smap(jnp.sin, v)
    assert isinstance(out, StridedView)
    np.testing.assert_allclose(np.asarray(out), np.sin(a), rtol=1e-12)


def test_smap_mixed_dense_input_still_returns_view(av):
    # mixing a plain array in: the reference falls back to Array results;
    # our conversion boundary is explicit (to_array / strided_jit), so the
    # engine keeps the strided type — assert that contract.
    a, v = av
    out = st.smap(jnp.add, v, jnp.asarray(a))
    assert isinstance(out, StridedView)


def test_smap_scalar_operand_returns_view(av):
    a, v = av
    out = st.smap(lambda x, s: x * s, v, 2.5)
    assert isinstance(out, StridedView)
    np.testing.assert_allclose(np.asarray(out), a * 2.5, rtol=1e-12)


def test_operators_build_lazy_expr(av):
    a, v = av
    e = (v + v.T.T) * 0.5 - 1.0
    assert isinstance(e, StridedExpr)
    # nested expression stays one flat lazy node (leaves inlined)
    e2 = e + v
    assert isinstance(e2, StridedExpr)
    assert len(e2.leaves) == 3
    np.testing.assert_allclose(np.asarray(e2), (a + a) * 0.5 - 1.0 + a, rtol=1e-12)


def test_operator_with_dense_array_is_lazy(av):
    a, v = av
    e = v + jnp.asarray(a)
    assert isinstance(e, StridedExpr)


def test_operator_with_scalar_is_lazy(av):
    a, v = av
    e = 3.0 * v
    assert isinstance(e, StridedExpr)
    np.testing.assert_allclose(np.asarray(e), 3 * a, rtol=1e-12)


def test_sbroadcast_returns_view(av):
    from strided_tpu import sbroadcast

    a, v = av
    out = sbroadcast(jnp.add, v, 1.0)
    assert isinstance(out, StridedView)


def test_reductions_return_arrays(av):
    a, v = av
    full = st.ssum(v)
    assert isinstance(full, jax.Array) and full.ndim == 0
    part = st.ssum(v, 0)
    assert isinstance(part, StridedView)  # dim-wise keeps the strided type
    assert part.shape == (1, 8)


def test_to_array_and_unstrided_boundaries(av):
    a, v = av
    arr = st.to_array(v)
    assert isinstance(arr, jax.Array) and arr.shape == (6, 8)
    arr2 = st.to_array(v + v)
    assert isinstance(arr2, jax.Array)
    from strided_tpu.api import maybe_unstrided, maybe_strided

    assert isinstance(maybe_unstrided(v), jax.Array)
    assert isinstance(maybe_unstrided(v + v), jax.Array)
    assert maybe_unstrided("passthrough") == "passthrough"
    assert isinstance(maybe_strided(jnp.asarray(a)), StridedView)
    assert maybe_strided(3.0) == 3.0


def test_strided_jit_returns_dense(av):
    a, v = av

    @st.strided_jit
    def f(x):
        return (x + x.T) / 2

    out = f(jnp.asarray(a[:6, :6]))
    assert isinstance(out, jax.Array)
    np.testing.assert_allclose(
        np.asarray(out), (a[:6, :6] + a[:6, :6].T) / 2, rtol=1e-12
    )


def test_at_set_returns_view(av):
    a, v = av
    out = v.at[::2].set(0.0)
    assert isinstance(out, StridedView) and out.shape == v.shape


def test_dispatch_logging(av, caplog):
    """The engine logs which backend ran each fused call."""
    import logging

    a, v = av
    with caplog.at_level(logging.DEBUG, logger="strided_tpu.dispatch"):
        st.smap(jnp.negative, v)
    assert any("fused_mapreduce" in r.message for r in caplog.records)
    assert any("-> xla" in r.getMessage() or "-> pallas" in r.getMessage()
               for r in caplog.records)
