"""strided_tpu — a strided-array kernel engine for JAX accelerators and a batched
MPC/trajectory-optimization stack.

Brand-new framework with the capabilities of Strided.jl
(`/root/reference`) re-designed for XLA devices: lazy strided views, a fused
multi-operand map/broadcast/reduce engine lowered through XLA and Pallas,
dot_general matmul with α/β semantics, and a shard_map-based multi-chip layer, all
feeding a batched MPC / trajectory-optimization stack.
"""

from .config import Config, get_config, set_config  # noqa: F401
from .core.view import (  # noqa: F401
    StridedView,
    StridedLayoutError,
    strided,
    as_view,
    isstrided,
    permutedims,
    transpose,
    adjoint,
    conj,
    sreshape,
    sview,
    set_view,
    flip,
    broadcast_to,
)
from .core.regularize import materialize  # noqa: F401
from .core.mapreduce import (  # noqa: F401
    smap,
    map_into,
    copy_into,
    permutedims_into,
    adjoint_into,
    conj_into,
    sreduce,
    sreduce_dims,
    mapreducedim_into,
    fused_mapreduce,
    ssum,
    sprod,
    smax,
    smin,
    smean,
)
from .core.broadcast import sbroadcast, sbroadcast_into, StridedExpr  # noqa: F401
from .linalg import mul, matmul, axpy, axpby, lmul, rmul, scale_into, contract  # noqa: F401
from .api import strided_jit, maybe_strided, maybe_unstrided, to_array  # noqa: F401
from .core.kernels_special import symmetrize, pair_axpby  # noqa: F401
from . import ops  # noqa: F401

__version__ = "0.1.0"
