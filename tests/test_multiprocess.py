"""Multi-process distributed execution proof.

The reference's scheduler is shared-memory only; the framework's DCN-facing
analog is ``jax.distributed`` + the same Mesh/shard_map code paths
(SURVEY §2.2 distributed-backend row). The virtual 8-device mesh used by
the rest of the suite exercises the collective *code*, but only within one
process; this test launches 2 REAL processes x 4 virtual CPU devices each
over a localhost coordinator and runs the consensus-control step and the
k-split matmul across the process boundary (implementation:
``strided_tpu/parallel/multiproc.py``, also run by
``__graft_entry__.dryrun_multichip``).
"""

from strided_tpu.parallel.multiproc import run_multiprocess_check


def test_two_process_mesh_consensus_and_ksplit():
    outs = run_multiprocess_check(nproc=2)
    # both processes must agree on the replicated consensus control
    lines = [
        next(l for l in out.splitlines() if l.startswith("MULTIPROC_OK"))
        for out in outs
    ]
    u_vals = {l.split("u=", 1)[1] for l in lines}
    assert len(u_vals) == 1, f"processes disagree on consensus u: {lines}"
