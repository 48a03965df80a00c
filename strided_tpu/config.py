"""Runtime configuration for strided_tpu.

Analog of the reference's runtime config layer
(`/root/reference/src/Strided.jl:18-52`): the reference keeps two
module-level knobs (`_NTHREADS`, `_use_threaded_mul`); here the toggles
select execution paths (hand-written Pallas kernels vs plain-XLA lowering,
dot_general matmul vs the generic engine), and :func:`kernel_mode` is the
one place that says which kernel paths exist on the running platform.

All values can be overridden via environment variables (prefix ``STRIDED_TPU_``)
or at runtime through :func:`set_config` / :func:`get_config`.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(f"STRIDED_TPU_{name}")
    return int(v) if v is not None else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(f"STRIDED_TPU_{name}")
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "off")


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen (hashable) configuration consulted by the dispatch layers.

    Mirrors the *roles* of the reference config (`src/Strided.jl:18-52`):

    - ``use_pallas``: master toggle for the hand-written Pallas kernels
      (analog of ``enable_threads``/``disable_threads``,
      `src/Strided.jl:34-35` — the reference's fast path on/off switch).
      Whether a kernel exists on the running platform at all is decided by
      :func:`kernel_mode`.
    - ``use_mxu``: analog of ``_use_threaded_mul`` (`src/Strided.jl:37-48`) —
      routes matmul through `lax.dot_general` (cuBLAS on the GPU) when
      eligible instead of the generic strided-reduce engine.
    """

    use_pallas: bool = _env_bool("USE_PALLAS", True)
    use_mxu: bool = _env_bool("USE_MXU", True)
    # Run the Pallas kernels in interpret mode. Only meaningful on the CPU
    # backend (the test suite sets it there); a GPU backend refuses it, see
    # kernel_mode().
    interpret: bool = _env_bool("INTERPRET", False)
    # Matmul precision for f32 products. On the GPU, 'highest' is IEEE FP32
    # (the default: the reference is an exact f64 CPU engine and the MPC
    # accuracy gate needs it); 'high' and 'default' allow TF32 tensor-core
    # products (about three decimal digits per operand).
    matmul_precision: str = os.environ.get("STRIDED_TPU_MATMUL_PRECISION", "highest")
    # Structured-pattern dispatch in the lazy-expression layer: recognize
    # (v + v.T) * alpha and its family and run the tile-pair kernel. Off ->
    # every expression takes the generic fused engine.
    expr_pattern_dispatch: bool = _env_bool("EXPR_PATTERN_DISPATCH", True)
    # Below this many elements the same-buffer pair pattern stays on XLA's
    # fused expression. Measured on an H100 (see PERF.md): device time
    # favours the kernel by 7% at 2048^2 and by 1.25-1.5x from 2896^2 up,
    # but eager wall time, which adds the host dispatch of the Python entry
    # point, favours it only from 4000^2 — the reference's flagship size.
    pair_kernel_min_elements: int = _env_int(
        "PAIR_KERNEL_MIN_ELEMENTS", 4000 * 4000
    )


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    """Replace fields of the global config; returns the new config."""
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config


def matmul_precision_scope(fn):
    """Decorator: trace ``fn`` under ``jax.default_matmul_precision`` set to
    the configured :attr:`Config.matmul_precision`.

    Rationale: on the GPU a bare ``@`` / ``jnp.einsum`` /
    ``solve_triangular`` may run at DEFAULT (TF32) precision, which
    silently degrades f32 math — the reference's contract is BLAS-grade f64
    CPU accuracy (`/root/reference/src/linalg.jl:44-63`), so every solver in
    the MPC stack wraps its body in this scope instead of relying on each
    call site remembering an explicit ``precision=`` argument. The scope is a
    trace-time effect: it applies to everything traced inside, including
    ``lax.scan`` bodies, and explicit ``precision=`` arguments still win."""
    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(get_config().matmul_precision):
            return fn(*args, **kwargs)

    return wrapped


def kernel_mode() -> Optional[str]:
    """Which hand-written Pallas kernels exist on the running platform —
    the single platform decision every kernel call site consults.

    - ``"triton"``: a GPU backend; kernels compile through Pallas's Triton
      route (``backend="triton"``).
    - ``"interpret"``: the CPU backend with ``Config.interpret`` set (the
      test suite); kernels run in Pallas interpret mode.
    - ``None``: no kernel — the CPU without ``interpret``, any other
      platform, or ``use_pallas`` off. Callers take the plain XLA path.

    ``interpret`` on a GPU backend raises instead of silently running the
    interpreter on the device."""
    import jax

    cfg = get_config()
    platform = jax.default_backend()
    if platform == "gpu":
        if cfg.interpret:
            raise RuntimeError(
                "Config.interpret is set on a GPU backend: Pallas kernels "
                "compile through Triton there; unset STRIDED_TPU_INTERPRET"
            )
        return "triton" if cfg.use_pallas else None
    if platform == "cpu" and cfg.interpret and cfg.use_pallas:
        return "interpret"
    return None


def enable_pallas() -> None:
    set_config(use_pallas=True)


def disable_pallas() -> None:
    set_config(use_pallas=False)


def enable_mxu() -> None:
    set_config(use_mxu=True)


def disable_mxu() -> None:
    set_config(use_mxu=False)
