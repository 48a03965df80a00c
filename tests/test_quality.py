"""Static-quality checks — the analog of the reference's Aqua.test_all pass
(`/root/reference/test/runtests.jl:26-27`): public API surface is importable,
exports resolve, pytrees round-trip, and the config stays hashable."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

MODULES = [
    "strided_tpu",
    "strided_tpu.config",
    "strided_tpu.api",
    "strided_tpu.linalg",
    "strided_tpu.ops",
    "strided_tpu.core.view",
    "strided_tpu.core.regularize",
    "strided_tpu.core.kernels_special",
    "strided_tpu.core.mapreduce",
    "strided_tpu.core.broadcast",
    "strided_tpu.core.lazy_expr",
    "strided_tpu.models",
    "strided_tpu.mpc",
    "strided_tpu.parallel",
    "strided_tpu.utils",
    "strided_tpu.utils.timing",
    "strided_tpu.utils.profiling",
    "strided_tpu.utils.compile_cache",
]


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports_and_exports_resolve(mod):
    m = importlib.import_module(mod)
    for name in getattr(m, "__all__", []):
        assert hasattr(m, name), f"{mod}.__all__ lists missing name {name}"


def test_view_pytree_roundtrip():
    import strided_tpu as st

    v = st.transpose(st.strided(jnp.arange(12.0).reshape(3, 4)))
    leaves, treedef = jax.tree_util.tree_flatten(v)
    assert len(leaves) == 1
    v2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert v2.shape == v.shape and v2.strides == v.strides
    np.testing.assert_array_equal(
        np.asarray(st.materialize(v2)), np.asarray(st.materialize(v))
    )


def test_controller_pytree_roundtrip():
    from strided_tpu.models import quadrotor, hover_state, hover_input
    from strided_tpu.mpc import make_hover_mpc

    m = quadrotor()
    Q = jnp.eye(12)
    R = jnp.eye(4)
    ctrl = make_hover_mpc(m, hover_state(jnp.float64), hover_input(dtype=jnp.float64),
                          Q, R, Q, horizon=4, dt=0.05)
    leaves, treedef = jax.tree_util.tree_flatten(ctrl)
    ctrl2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert ctrl2.qp.N == ctrl.qp.N


def test_config_hashable_and_env_roundtrip():
    from strided_tpu.config import Config, get_config

    hash(get_config())
    c = Config()
    assert isinstance(c.pair_kernel_min_elements, int)


def test_checkpoint_roundtrip(tmp_path):
    from strided_tpu.models import quadrotor, hover_state, hover_input
    from strided_tpu.mpc import make_hover_mpc
    from strided_tpu.utils import save_pytree, load_pytree

    m = quadrotor()
    Q = jnp.eye(12)
    R = jnp.eye(4)
    ctrl = make_hover_mpc(m, hover_state(jnp.float64), hover_input(dtype=jnp.float64),
                          Q, R, Q, horizon=4, dt=0.05)
    p = str(tmp_path / "ctrl.npz")
    save_pytree(p, ctrl)
    ctrl2 = load_pytree(p, ctrl)
    np.testing.assert_allclose(np.asarray(ctrl2.qp.H), np.asarray(ctrl.qp.H))
    # structure mismatch must raise
    with pytest.raises(ValueError):
        load_pytree(p, {"not": "a controller", "x": jnp.zeros(3)})


def test_timing_helpers_on_cpu():
    from strided_tpu.utils import time_fn, time_chained, bandwidth_gbs

    f = jax.jit(lambda x: x * 2.0)
    x = jnp.ones((64, 64))
    t1 = time_fn(f, x, inner=2, repeats=1, warmup=1)
    t2 = time_chained(f, x, inner=2, repeats=1)
    assert t1 > 0 and t2 > 0
    assert bandwidth_gbs(1e9, 1.0) == 1.0


def test_profiling_timer_and_annotation():
    from strided_tpu.utils import Timer, annotate

    out = []
    with Timer("phase", sink=out.append):
        with annotate("inner"):
            _ = jnp.ones(8) + 1
    assert out and "phase" in out[0]


def test_checkpoint_legacy_per_leaf_validation(tmp_path):
    """a pre-r4 (manifest-less) checkpoint with the SAME
    leaf count but different per-leaf shapes/dtypes must be rejected, not
    silently mis-assigned."""
    from strided_tpu.utils import load_pytree

    p = str(tmp_path / "legacy.npz")
    tree = {"a": np.zeros((3, 4), np.float32), "b": np.ones(5, np.int32)}
    # legacy writer: leaves only, no __manifest__
    np.savez(p, leaf_0=tree["a"], leaf_1=tree["b"])
    # matching template loads
    got = load_pytree(p, tree)
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"])
    # same leaf COUNT, different shapes -> ValueError (per-leaf check)
    bad = {"a": np.zeros((4, 3), np.float32), "b": np.ones(5, np.int32)}
    with pytest.raises(ValueError, match="leaf 0 mismatch"):
        load_pytree(p, bad)
    # same shapes, different dtype -> ValueError
    bad2 = {"a": np.zeros((3, 4), np.float64), "b": np.ones(5, np.int32)}
    with pytest.raises(ValueError, match="leaf 0 mismatch"):
        load_pytree(p, bad2)


def test_adoption_densifies_small_window_over_huge_base():
    """a small stride_tricks window over a much larger
    base densifies host-side instead of uploading the whole base; a view
    covering most of its base still adopts the lazy layout."""
    import strided_tpu as st

    base = np.arange(2_000_000, dtype=np.float32)  # 8 MB: above the cutoff
    win = np.lib.stride_tricks.as_strided(base, shape=(8, 8), strides=(400, 4))
    v = st.strided(win)
    assert int(v.parent.shape[0]) == 64  # densified, not the 2M base
    np.testing.assert_array_equal(np.asarray(st.to_array(v)), win)
    # a transposed full matrix (base == view size) still adopts
    m = np.arange(64 * 48, dtype=np.float32).reshape(64, 48).T
    w = st.strided(m)
    assert w.strides == (1, 48)
    np.testing.assert_array_equal(np.asarray(st.to_array(w)), m)


def test_time_interleaved_harness():
    """The collapse-proof interleaved-chain harness is a library utility:
    m chains advanced in place, slope per single application."""
    from strided_tpu.utils import time_interleaved

    arrs = [jnp.ones((32, 32)) * i for i in range(3)]
    sec = time_interleaved(lambda x: x + 1.0, arrs, k1=2, k2=6, repeats=1)
    assert np.isfinite(sec)
