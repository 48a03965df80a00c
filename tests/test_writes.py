"""Zero-copy strided write path.

The reference's ``map!`` writes through ANY strided view with zero allocation
(`/root/reference/src/mapreduce.jl:38-53`). The XLA analog: a non-overlapping
strided write lowers to the inverse pad/reshape/slice cascade + ONE windowed
``dynamic_update_slice`` — no O(n) index tensors, no gather/scatter in the
HLO. These tests pin (a) the HLO contract, (b) value correctness for a fuzzed
battery of layouts against numpy assignment semantics, and (c) that buffer
donation flows through ``strided_jit``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import strided_tpu as st
from strided_tpu.core.view import StridedView, sview
from strided_tpu.core.regularize import scatter_into


def _hlo_of_update(update_fn, *arrs):
    return jax.jit(update_fn).lower(*arrs).as_text()


def _assert_no_gather_scatter(hlo: str, what: str):
    low = hlo.lower()
    assert "scatter" not in low, f"{what}: scatter in HLO"
    assert "gather" not in low, f"{what}: gather in HLO"
    # jnp.take / .at[].set fallbacks show up as dynamic-gather/scatter too,
    # but also catch explicit index-tensor construction (iota * stride adds
    # are fine; 1-D index operands into gather are not — covered above).


def test_strided_slice_write_hlo_has_no_scatter():
    """``v.at[::2, :].set(expr)`` must lower to pad/reshape/slice/dus."""
    a = jnp.zeros((16, 8), jnp.float32)

    def upd(a):
        v = st.strided(a)
        return st.to_array(v.at[::2, :].set(1.5))

    _assert_no_gather_scatter(_hlo_of_update(upd, a), "at[::2,:].set")


def test_strided_inner_stride_write_hlo_has_no_scatter():
    """Strided innermost dim (gaps between elements)."""
    a = jnp.zeros((8, 32), jnp.float32)

    def upd(a):
        v = st.strided(a)
        return st.to_array(v.at[:, 1::3].set(2.0))

    _assert_no_gather_scatter(_hlo_of_update(upd, a), "at[:,1::3].set")


def test_transposed_write_hlo_has_no_scatter():
    a = jnp.zeros((8, 8), jnp.float32)

    def upd(a):
        v = st.transpose(st.strided(a))
        return st.to_array(v.at[1:5, ::2].set(3.0))

    _assert_no_gather_scatter(_hlo_of_update(upd, a), "transposed at[].set")


def test_overlapping_write_still_uses_scatter():
    """Views visiting an element twice genuinely need scatter semantics —
    the fallback must remain for them."""
    flat = jnp.zeros(8, jnp.float32)
    v = StridedView(flat, (2, 2), (1, 1), 0)  # overlapping by construction
    hlo = jax.jit(lambda f: scatter_into(StridedView(f, (2, 2), (1, 1), 0),
                                         jnp.ones((2, 2), jnp.float32))).lower(flat).as_text()
    assert "scatter" in hlo.lower()


@pytest.mark.parametrize("seed", range(8))
def test_fuzzed_strided_writes_match_numpy(seed):
    """Random layout (permute / slice-with-step / flip) writes vs numpy."""
    rng = np.random.default_rng(seed)
    shape = tuple(rng.integers(2, 7, size=rng.integers(2, 5)))
    base = rng.standard_normal(shape).astype(np.float32)
    v = st.strided(jnp.asarray(base))
    expect = base.copy()

    # random lazy transform
    perm = tuple(rng.permutation(len(shape)))
    v = st.permutedims(v, perm)
    expect_t = np.transpose(expect, perm)

    # random subview: step slices, occasional flip
    idx = []
    for d in v.shape:
        step = int(rng.integers(1, 3))
        if rng.random() < 0.3:
            idx.append(slice(None, None, -step))
        else:
            start = int(rng.integers(0, d))
            idx.append(slice(start, None, step))
    idx = tuple(idx)
    sub = sview(v, idx)
    vals = rng.standard_normal(sub.shape).astype(np.float32)

    new_parent = scatter_into(sub, jnp.asarray(vals))
    got = np.asarray(new_parent).reshape(shape)

    expect_t[idx] = vals  # numpy basic-indexing assignment through the view
    np.testing.assert_array_equal(got, expect)  # expect_t aliases expect


def test_write_preserves_untouched_elements_exactly():
    base = np.arange(100, dtype=np.float32).reshape(10, 10)
    v = st.strided(jnp.asarray(base))
    got = np.asarray(st.to_array(v.at[2:8:2, 3:9:3].set(-1.0)))
    expect = base.copy()
    expect[2:8:2, 3:9:3] = -1.0
    np.testing.assert_array_equal(got, expect)


def test_strided_jit_donation_passthrough():
    """``strided_jit(donate_argnums=0)`` marks the input for buffer reuse —
    in-place update semantics without a parent copy where the backend
    supports donation."""

    @st.strided_jit(donate_argnums=0)
    def upd(a):
        v = st.strided(a)
        return v.at[::2, :].set(0.0)

    a = jnp.asarray(np.ones((16, 16), np.float32))
    lowered = upd.lower(a).as_text()
    # donated params carry an input-output alias marker in the lowering
    assert "tf.aliasing_output" in lowered or "jax.buffer_donor" in lowered
    out = upd(a)
    expect = np.ones((16, 16), np.float32)
    expect[::2, :] = 0.0
    np.testing.assert_array_equal(np.asarray(out), expect)
