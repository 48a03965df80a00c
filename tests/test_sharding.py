"""Multi-chip layer tests on the virtual 8-device CPU mesh — the analog of
the reference running its whole suite under 4 threads
(`/root/reference/test/runtests.jl:17-20`): identical value-level assertions
under real concurrency/sharding (SURVEY.md §4 transfer rule 2)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from strided_tpu.models import double_pendulum, quadrotor, hover_state, hover_input
from strided_tpu.mpc import rollout, make_hover_mpc
from strided_tpu.parallel import (
    make_mesh,
    shard_batch,
    sharded_rollout,
    sharded_mpc_step,
    scenario_consensus_control,
    data_sharding,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    return make_mesh()


def test_mesh_shape(mesh):
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ("data",)


def test_sharded_rollout_matches_local(mesh):
    m = double_pendulum()
    B, T = 64, 20
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.standard_normal((B, 4)) * 0.1)
    us = jnp.asarray(rng.standard_normal((B, T, 2)) * 0.01)
    local = rollout(m, x0, us, dt=0.01)
    f = jax.jit(sharded_rollout(m, mesh, dt=0.01))
    x0s = jax.device_put(x0, data_sharding(mesh, 2))
    uss = jax.device_put(us, data_sharding(mesh, 3))
    sharded = f(x0s, uss)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(local), rtol=1e-12)


def test_shard_batch_generic(mesh):
    f = lambda x: jnp.sin(x) * 2.0
    g = jax.jit(shard_batch(f, mesh))
    x = jnp.arange(32.0).reshape(32, 1)
    np.testing.assert_allclose(np.asarray(g(x)), np.sin(np.arange(32.0))[:, None] * 2)


def test_sharded_mpc_step_matches_local(mesh):
    dt = 0.05
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], jnp.float64))
    R = jnp.eye(4, dtype=jnp.float64) * 0.1
    ctrl = make_hover_mpc(
        model, hover_state(jnp.float64), hover_input(dtype=jnp.float64),
        Q, R, Q, horizon=8, dt=dt,
        u_min=jnp.array([-5.0, -0.2, -0.2, -0.2]),
        u_max=jnp.array([10.0, 0.2, 0.2, 0.2]),
    )
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(-0.2, 0.2, (16, 12)))
    # local
    u_local, _ = ctrl.control(x)
    xn_local = model.step(x, u_local, dt)
    # sharded
    step = jax.jit(sharded_mpc_step(ctrl, model, mesh, dt))
    xs = jax.device_put(x, data_sharding(mesh, 2))
    xn, u = step(xs)
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_local), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(xn), np.asarray(xn_local), rtol=1e-9)


def test_consensus_control_is_global_mean(mesh):
    dt = 0.05
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], jnp.float64))
    R = jnp.eye(4, dtype=jnp.float64) * 0.1
    ctrl = make_hover_mpc(
        model, hover_state(jnp.float64), hover_input(dtype=jnp.float64),
        Q, R, Q, horizon=8, dt=dt,
    )
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.uniform(-0.2, 0.2, (32, 12)))
    u_all, _ = ctrl.control(x)
    expect = np.asarray(u_all).mean(axis=0)
    f = jax.jit(scenario_consensus_control(ctrl, mesh))
    xs = jax.device_put(x, data_sharding(mesh, 2))
    u_cons, _ = f(xs)
    np.testing.assert_allclose(np.asarray(u_cons), expect, rtol=1e-9)


# ---- tensor-parallel matmul (the D&C threaded gemm analog) ----


@pytest.mark.parametrize("split", ["n", "m", "k"])
def test_tp_matmul_matches_dense(mesh, split):
    from strided_tpu.parallel import matmul_nsplit, matmul_msplit, matmul_ksplit

    rng = np.random.default_rng(7)
    A = jnp.asarray(rng.standard_normal((48, 64)))
    B = jnp.asarray(rng.standard_normal((64, 56)))
    fn = {"n": matmul_nsplit, "m": matmul_msplit, "k": matmul_ksplit}[split]
    C = jax.jit(lambda a, b: fn(a, b, mesh))(A, B)
    np.testing.assert_allclose(np.asarray(C), np.asarray(A) @ np.asarray(B), rtol=1e-10)


# -- sharded engine ops (cross-chip tier of the kernel engine) ---------------


def test_choose_split_dim_rule():
    from strided_tpu.parallel import choose_split_dim

    # contiguous 2-D: dim 0 has stride n (cost 2n), dim 1 stride 1 (cost 2);
    # scores (d-1)*cost -> dim 0 wins (split the slow axis, like the
    # reference's task tree splitting the outer loop).
    assert choose_split_dim((64, 64), ((64, 1), (64, 1))) == 0
    # reduction dims are never split
    assert choose_split_dim((64, 64), ((64, 1),), reduction_dims=(0,)) == 1
    # size-1 dims are never split
    assert choose_split_dim((1, 64), ((64, 1),)) == 1


def test_sharded_smap_matches_local(mesh):
    import strided_tpu as st
    from strided_tpu.parallel import sharded_smap

    a = np.random.default_rng(3).standard_normal((64, 32))
    v = st.strided(jnp.asarray(a))

    @jax.jit
    def f(v):
        return sharded_smap(
            lambda x, y: x + 2 * y, mesh, v, st.strided(jnp.asarray(a))
        )

    out = f(v)
    # API symmetry with the local engine: sharded_smap returns a StridedView
    assert isinstance(out, st.StridedView)
    np.testing.assert_allclose(np.asarray(out), 3 * a, rtol=1e-12)
    # the flat parent buffer is genuinely sharded over 8 devices
    assert len(out.parent.sharding.device_set) == 8


def test_sharded_reduce_partial_and_complete(mesh):
    import strided_tpu as st
    from strided_tpu.parallel import sharded_reduce

    a = np.random.default_rng(4).standard_normal((64, 48))
    v = st.strided(jnp.asarray(a))

    @jax.jit
    def partial(v):
        return sharded_reduce(lambda x: x, jnp.add, v, mesh, axes=1)

    got = partial(v)
    assert isinstance(got, st.StridedView)  # local-engine API symmetry
    np.testing.assert_allclose(np.asarray(got), a.sum(1), rtol=1e-12)
    assert len(got.parent.sharding.device_set) == 8

    @jax.jit
    def complete(v):
        return sharded_reduce(jnp.abs, jnp.maximum, v, mesh)

    np.testing.assert_allclose(float(complete(v)), np.abs(a).max(), rtol=1e-12)


def test_sharded_reduce_over_lazy_expr(mesh):
    import strided_tpu as st
    from strided_tpu.parallel import sharded_reduce

    a = np.random.default_rng(5).standard_normal((32, 32))
    v = st.strided(jnp.asarray(a))
    e = (v + st.transpose(v)) / 2  # lazy expression leaves get sharded

    @jax.jit
    def f(v):
        e = (v + st.transpose(v)) / 2
        return sharded_reduce(lambda x: x, jnp.add, e, mesh)

    np.testing.assert_allclose(float(f(v)), ((a + a.T) / 2).sum(), rtol=1e-11)


def test_make_mesh_clamps_1d_overask_with_warning():
    """1-D over-ask clamps + warns — the reference's thread-count clamp
    analog (`/root/reference/src/Strided.jl:21-32`)."""
    from strided_tpu.parallel import make_mesh
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mesh = make_mesh(axis_sizes=(len(jax.devices()) + 5,))
    assert mesh.devices.size == len(jax.devices())
    assert any("clamping" in str(x.message) for x in w)
    # multi-D over-ask still errors (no sensible clamp)
    with pytest.raises(ValueError):
        make_mesh(axis_sizes=(len(jax.devices()), 2), axis_names=("data", "model"))


def test_2d_mesh_data_model_matmul():
    """2-D ('data','model') mesh: batch sharded over data, matmul columns
    over model — the mesh shape SURVEY §2.2 calls for."""
    from strided_tpu.parallel import make_mesh, matmul_nsplit
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(axis_sizes=(4, 2), axis_names=("data", "model"))
    rng = np.random.default_rng(21)
    X = jnp.asarray(rng.standard_normal((16, 32)))
    W = jnp.asarray(rng.standard_normal((32, 24)))
    Xs = jax.device_put(X, NamedSharding(mesh, P("data", None)))

    @jax.jit
    def f(x, w):
        y = matmul_nsplit(x, w, mesh, axis="model")
        return jax.nn.relu(y)

    got = f(Xs, W)
    np.testing.assert_allclose(
        np.asarray(got), np.maximum(np.asarray(X) @ np.asarray(W), 0), rtol=1e-10
    )


def test_init_distributed_noop_and_env_paths(monkeypatch):
    """The multi-host entry point's decision logic:
    single-process is a no-op; explicit args or a >1-process cluster env
    trigger `jax.distributed.initialize`; repeat calls are idempotent."""
    from strided_tpu.parallel import dist

    calls = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: calls.append(kw)
    )
    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)

    # 1. bare single-process call: no-op
    assert dist.init_distributed() is False
    # 2. explicit num_processes=1: still a no-op
    assert dist.init_distributed(num_processes=1) is False
    # 3. env says 1 process: no-op even with an address
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert dist.init_distributed() is False
    assert calls == []

    # 4. cluster env (>1 processes): initializes
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    assert dist.init_distributed() is True
    assert len(calls) == 1

    # 5. idempotent: second call is a no-op returning True
    assert dist.init_distributed() is True
    assert len(calls) == 1

    # 6. explicit args (fresh state): passed through
    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    assert dist.init_distributed(
        coordinator_address="h0:9999", num_processes=4, process_id=0
    ) is True
    assert calls[-1]["coordinator_address"] == "h0:9999"
    assert calls[-1]["num_processes"] == 4


# -- HLO collective assertions ----------------
# The SPMD analog of the reference's race-freedom-by-construction proof
# (/root/reference/src/mapreduce.jl:172-177): reductions lower to exactly
# the collectives the design calls for — one all-reduce for the combine,
# and NO all-gather (which would mean GSPMD gave up on partitioning and
# replicated the data instead).


def _compiled_hlo(jitted, *args):
    return jitted.lower(*args).compile().as_text()


def _count(hlo, op):
    import re

    return len(re.findall(rf"\b{op}\b", hlo))


def test_hlo_ksplit_matmul_one_allreduce_no_allgather(mesh):
    from strided_tpu.parallel import matmul_ksplit
    from jax.sharding import NamedSharding, PartitionSpec as P

    A = jnp.zeros((32, 64), jnp.float32)
    B = jnp.zeros((64, 16), jnp.float32)
    As = jax.device_put(A, NamedSharding(mesh, P(None, "data")))
    Bs = jax.device_put(B, NamedSharding(mesh, P("data", None)))
    f = jax.jit(lambda a, b: matmul_ksplit(a, b, mesh))
    hlo = _compiled_hlo(f, As, Bs)
    assert _count(hlo, "all-reduce") == 1, hlo
    assert _count(hlo, "all-gather") == 0, hlo


def test_hlo_consensus_step_one_allreduce_no_allgather(mesh):
    dtype = jnp.float32
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    ctrl = make_hover_mpc(
        model, hover_state(dtype), hover_input(dtype=dtype), Q, R, Q,
        horizon=6, dt=0.02,
        u_min=jnp.array([-5.0, -0.5, -0.5, -0.5], dtype),
        u_max=jnp.array([10.0, 0.5, 0.5, 0.5], dtype),
        admm_iters=5,
    )
    x = jax.device_put(jnp.zeros((16, 12), dtype), data_sharding(mesh, 2))
    f = jax.jit(scenario_consensus_control(ctrl, mesh))
    hlo = _compiled_hlo(f, x)
    # exactly ONE all-reduce: the consensus pmean; the per-scenario QP
    # solves stay device-local (scenario dim never gathered)
    assert _count(hlo, "all-reduce") == 1, _count(hlo, "all-reduce")
    assert _count(hlo, "all-gather") == 0


def test_hlo_sharded_engine_partitions_not_gathers(mesh):
    """sharded_smap/sharded_reduce really partition:
    the jitted module must contain no all-gather, and the partial-reduction
    case no collective at all (device-disjoint outputs)."""
    import strided_tpu as st
    from strided_tpu.parallel import sharded_smap, sharded_reduce

    a = jnp.zeros((64, 32), jnp.float32)

    @jax.jit
    def fmap(arr):
        return sharded_smap(lambda p, q: p * q + 1.0, mesh, st.strided(arr),
                            st.strided(arr)).parent

    hlo = _compiled_hlo(fmap, a)
    assert _count(hlo, "all-gather") == 0
    assert _count(hlo, "all-reduce") == 0

    @jax.jit
    def fpart(arr):
        return sharded_reduce(lambda z: z, jnp.add, st.strided(arr), mesh,
                              axes=1).parent

    hlo = _compiled_hlo(fpart, a)
    assert _count(hlo, "all-gather") == 0, hlo

    @jax.jit
    def ftot(arr):
        return sharded_reduce(jnp.abs, jnp.maximum, st.strided(arr), mesh)

    hlo = _compiled_hlo(ftot, a)
    # complete reduction: the combine must be a single all-reduce-class
    # collective, never a gather of the data
    assert _count(hlo, "all-gather") == 0, hlo
    assert _count(hlo, "all-reduce") >= 1


def test_pallas_kernels_under_shard_map(mesh):
    """SURVEY §2.2 row 1: the two-tier schedule — kernel grid INSIDE each
    device's shard_map region, collectives across the mesh — lowers and
    executes. Pins (a) the tile-pair kernel per-device over a sharded batch
    and (b) the per-shard leading-axis sum with a psum combine."""
    from strided_tpu.config import set_config, get_config
    from strided_tpu.parallel import sharded_batched_pair, sharded_stream_sum

    old = get_config()
    try:
        set_config(use_pallas=True, pair_kernel_min_elements=1024)
        rng = np.random.default_rng(31)
        x = jnp.asarray(rng.standard_normal((8, 256, 256)), jnp.float32)
        # per-device pair kernel must be eligible (the gate is consulted at
        # trace time inside the shard_map region)
        from strided_tpu.core.kernels_special import pair_kernel_tile

        assert pair_kernel_tile(256, 256, np.dtype('float32')) is not None
        f = jax.jit(lambda x: sharded_batched_pair(x, mesh, scale_mode="mul", scale=0.5))
        got = np.asarray(f(x))
        xn = np.asarray(x)
        np.testing.assert_allclose(
            got, (xn + np.swapaxes(xn, 1, 2)) * 0.5, rtol=1e-6, atol=1e-6
        )

        a = jnp.asarray(rng.standard_normal((1024, 256)), jnp.float32)
        g = jax.jit(lambda a: sharded_stream_sum(a, mesh))
        got = np.asarray(g(a))
        np.testing.assert_allclose(
            got, np.asarray(a).sum(0), rtol=1e-4, atol=1e-3
        )
    finally:
        set_config(**{k: getattr(old, k) for k in old.__dataclass_fields__})


def test_hlo_split_dim_choice_drives_partitioning(mesh):
    """the planner's split-dim heuristic must actually
    CHANGE the partitioned HLO, not just decorate it. A plain row-major
    leaf makes ``choose_split_dim`` pick dim 0 (largest (d-1)*cost); the
    LAZY-TRANSPOSED leaf of the same buffer flips the cost profile so dim 1
    wins — and the compiled module's sharding annotations must follow."""
    import strided_tpu as st
    from strided_tpu.parallel import sharded_smap, choose_split_dim

    a = jnp.zeros((64, 32), jnp.float32)
    at = jnp.zeros((32, 64), jnp.float32)

    # the heuristic itself (contract-level)
    assert choose_split_dim((64, 32), ((32, 1),)) == 0
    assert choose_split_dim((64, 32), ((1, 64),)) == 1

    @jax.jit
    def f_plain(arr):
        return sharded_smap(lambda p: p + 1.0, mesh, st.strided(arr)).parent

    @jax.jit
    def f_transposed(arr):
        # lazy transpose: logical (64, 32), strides (1, 64)
        return sharded_smap(
            lambda p: p + 1.0, mesh, st.transpose(st.strided(arr))
        ).parent

    hlo_plain = _compiled_hlo(f_plain, a)
    hlo_t = _compiled_hlo(f_transposed, at)
    # Post-SPMD the module carries LOCAL shapes: the (64, 32) plain input
    # splits dim 0 -> per-device parameter f32[8,32]; for the transposed
    # leaf the heuristic picks logical dim 1, which is dim 0 of the (32,64)
    # input buffer -> per-device parameter f32[4,64]. The wrong choice
    # would produce f32[64,4] / f32[8,32] instead.
    assert "f32[8,32]" in hlo_plain.split("\n")[0], hlo_plain[:300]
    assert "f32[4,64]" in hlo_t.split("\n")[0], hlo_t[:300]
    assert "f32[64,4]" not in hlo_t.split("\n")[0]
