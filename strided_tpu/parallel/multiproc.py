"""Multi-process distributed-runtime proof harness (SURVEY §2.2
distributed-backend row).

The reference's scheduler is shared-memory only; the framework's cross-process
analog is ``jax.distributed`` + the same Mesh/shard_map code paths. This
module provides an *executable* proof that those paths work across real
process boundaries: :func:`run_multiprocess_check` launches N localhost
worker processes (each hosting 4 virtual CPU devices) joined through
``jax.distributed.initialize`` via the library's
:func:`~strided_tpu.parallel.dist.init_distributed` seam, and each worker
runs the production cross-host surface — the scenario-consensus MPC step
(QP solves + ``pmean`` all-reduce crossing the process boundary) and the
k-split tensor-parallel matmul (``psum``) — validated against
process-local oracles.

Used by ``tests/test_multiprocess.py`` and by
``__graft_entry__.dryrun_multichip``. Worker entry:
``python -m strided_tpu.parallel.multiproc <coordinator> <nproc> <pid>``.
Only the spawner depends on this package being importable in the parent;
workers need nothing beyond the library itself.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

__all__ = ["run_multiprocess_check", "worker_main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multiprocess_check(nproc: int = 2, timeout: int = 300):
    """Spawn ``nproc`` workers; returns their stdouts (each containing a
    ``MULTIPROC_OK`` line). Raises AssertionError on any worker failure."""
    addr = f"127.0.0.1:{_free_port()}"
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_PROCESSES",
                     "JAX_COORDINATOR_ADDRESS", "JAX_PROCESS_ID")
    }
    # workers import strided_tpu; make sure the repo root is importable even
    # when the parent found it via sys.path manipulation
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "strided_tpu.parallel.multiproc",
             addr, str(nproc), str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIPROC_OK" in out, f"worker {pid} produced no OK line:\n{out}"
    return outs


def worker_main(addr: str, nproc: int, pid: int) -> None:
    """One worker: 4 virtual CPU devices, join the global mesh, run the
    consensus MPC step + k-split matmul, validate, print MULTIPROC_OK."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "").split("--xla_force_host_platform")[0]
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .dist import init_distributed
    from .mesh import make_mesh
    from .tp import matmul_ksplit
    from .sharded import scenario_consensus_control

    ok = init_distributed(
        coordinator_address=addr, num_processes=nproc, process_id=pid
    )
    assert ok, "init_distributed took the single-process no-op path"
    devs = jax.devices()
    assert len(devs) == 4 * nproc, (
        f"expected {4 * nproc} global devices, got {len(devs)}"
    )
    assert len(jax.local_devices()) == 4
    mesh = make_mesh(devices=devs)

    # ---- k-split TP matmul: psum crosses the process boundary ----
    rng = np.random.default_rng(0)  # same seed everywhere: replicated inputs
    k = 4 * len(devs)
    A = rng.standard_normal((16, k)).astype(np.float32)
    B = rng.standard_normal((k, 12)).astype(np.float32)
    Ad = jax.device_put(jnp.asarray(A), NamedSharding(mesh, P(None, "data")))
    Bd = jax.device_put(jnp.asarray(B), NamedSharding(mesh, P("data", None)))
    C = jax.jit(lambda p, q: matmul_ksplit(p, q, mesh))(Ad, Bd)
    jax.block_until_ready(C)
    assert np.allclose(np.asarray(C), A @ B, atol=1e-3), "k-split matmul mismatch"

    # ---- scenario-consensus MPC step: QP solves + cross-process pmean ----
    from ..models import quadrotor, hover_state, hover_input
    from ..mpc import make_hover_mpc

    dtype = jnp.float32
    model = quadrotor()
    Q = jnp.diag(jnp.array([10, 10, 10, 1, 1, 1, 5, 5, 5, 1, 1, 1], dtype))
    R = jnp.eye(4, dtype=dtype) * 0.1
    ctrl = make_hover_mpc(
        model, hover_state(dtype), hover_input(dtype=dtype), Q, R, Q,
        horizon=8, dt=0.02,
        u_min=jnp.array([-5.0, -0.5, -0.5, -0.5], dtype),
        u_max=jnp.array([10.0, 0.5, 0.5, 0.5], dtype),
        admm_iters=10,
    )
    Bsz = 2 * len(devs)
    x = rng.uniform(-0.2, 0.2, (Bsz, 12)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    cons = jax.jit(scenario_consensus_control(ctrl, mesh))
    u_cons, _plans = cons(xs)
    jax.block_until_ready(u_cons)
    # process-local oracle: equal shard sizes => pmean of local means is the
    # global mean of per-scenario first inputs
    u_ref = np.mean(np.asarray(jax.jit(ctrl.control)(jnp.asarray(x))[0]), axis=0)
    assert np.allclose(np.asarray(u_cons), u_ref, atol=1e-5), (
        f"consensus mismatch: {np.asarray(u_cons)} vs {u_ref}"
    )

    print(f"MULTIPROC_OK pid={pid} devices={len(devs)} "
          f"u={np.asarray(u_cons).round(6).tolist()}")


if __name__ == "__main__":
    worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
