"""Device-mesh helpers — the multi-chip layer's foundation.

The reference's only parallel substrate is the intra-process task tree
(`/root/reference/src/mapreduce.jl:195-227`); its JAX-native replacement
(SURVEY.md §2.2) is a `jax.sharding.Mesh` with named axes, collectives over
the device interconnect, and `shard_map` regions. This module centralizes mesh construction
so tests (8 virtual CPU devices), the driver's multi-chip dry-run, and real
pod slices all go through the same code.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "replicated", "P"]


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over the available devices.

    Default: a 1-D ``('data',)`` mesh over all devices — scenario/data
    parallelism is the north star's primary axis (BASELINE.json: scenario
    sharding + QP-block all-reduce). Pass e.g. ``axis_sizes=(4, 2),
    axis_names=('data', 'model')`` for 2-D meshes."""
    devices = list(jax.devices() if devices is None else devices)
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    want = int(np.prod(axis_sizes))
    if want > len(devices):
        # 1-D over-ask clamps with a warning — the analog of the reference's
        # thread-count clamp + `@warn` (`/root/reference/src/Strided.jl:21-32`).
        if len(axis_sizes) == 1:
            import warnings

            warnings.warn(
                f"mesh wants {want} devices, only {len(devices)} available; "
                f"clamping '{axis_names[0]}' axis to {len(devices)}",
                stacklevel=2,
            )
            axis_sizes = (len(devices),)
            want = len(devices)
        else:
            raise ValueError(
                f"mesh wants {want} devices, only {len(devices)} available"
            )
    arr = np.array(devices[:want]).reshape(axis_sizes)
    return Mesh(arr, tuple(axis_names))


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0, name: str = "data"):
    """NamedSharding that shards dim ``axis`` of a rank-``ndim`` array over
    mesh axis ``name``, replicating the rest."""
    spec = [None] * ndim
    spec[axis] = name
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
