"""Multi-host runtime initialization — the cross-host entry point.

The reference is a single-process shared-memory library; its "runtime init"
is ``__init__`` enabling all Julia threads (`/root/reference/src/Strided.jl:50-52`).
The JAX-native analog for scaling past one host (SURVEY §2.2 distributed-
backend row, §7 L6) is the JAX distributed runtime: every host calls
:func:`init_distributed` before building meshes; afterwards ``jax.devices()``
spans every host and the same ``Mesh``/``shard_map`` code paths run
collectives over NVLink within a host and the network across hosts.

Single-process (tests, one chip, CPU) it is a documented no-op, so library
code can call it unconditionally.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["init_distributed"]

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Initialize the JAX distributed runtime for multi-host meshes.

    Returns ``True`` if ``jax.distributed.initialize`` was called, ``False``
    for the single-process no-op. Explicit arguments win; otherwise the
    standard cluster environment (``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, or a cluster runtime that
    JAX auto-detects) is consulted. Idempotent: repeat calls are no-ops.
    """
    global _initialized
    if _initialized:
        return True
    env_addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_n = os.environ.get("JAX_NUM_PROCESSES")
    explicit = coordinator_address is not None or num_processes not in (None, 1)
    from_env = env_addr is not None and (env_n is None or int(env_n) > 1)
    if not explicit and not from_env:
        return False  # single process: nothing to coordinate
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _initialized = True
    return True
