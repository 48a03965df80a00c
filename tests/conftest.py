"""Test harness configuration.

Mirrors the reference harness strategy (`/root/reference/test/runtests.jl:1-27`):
the reference runs its whole suite once single-threaded and once
multi-threaded; our analog is running on a virtual 8-device CPU mesh
(``xla_force_host_platform_device_count=8``) so every sharded code path is
exercised without accelerator hardware, with the Pallas kernels in
interpret mode (``Config.interpret``, which the platform gate
``config.kernel_mode`` honours only on the CPU).

Tests marked ``gpu`` need an NVIDIA card: the ``gpu`` fixture skips them
elsewhere. Run them on the card with
``STRIDED_TPU_TEST_DEVICE=gpu python -m pytest tests/ -m gpu``, which keeps
the default (GPU) platform and compiles the kernels through Triton.

**Engine-config matrix** (the analog of the reference's three whole-suite
passes at `/root/reference/test/runtests.jl:12-24`): set
``STRIDED_TPU_TEST_PROFILE`` to re-run the ENTIRE suite under a forced
engine configuration:

- ``default`` — production dispatch policy;
- ``pallas``  — the tile-pair kernel engaged at every size;
- ``xla``     — hand-written kernels disabled, everything through XLA;
- ``nomxu``   — matmul's dot_general dispatch disabled, generic engine path
  for all ``mul`` calls (the analog of the reference's threaded-mul toggle
  pass).

``tests/run_matrix.py`` runs all four; CI runs each as a matrix job.
"""

import os

ON_GPU = os.environ.get("STRIDED_TPU_TEST_DEVICE", "cpu") == "gpu"

# Must run before jax is imported anywhere.
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

TEST_PROFILES = {
    "default": {},
    "pallas": dict(use_pallas=True, pair_kernel_min_elements=256),
    "xla": dict(use_pallas=False),
    "nomxu": dict(use_mxu=False),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX finds none"
    )
    profile = os.environ.get("STRIDED_TPU_TEST_PROFILE", "default")
    if profile not in TEST_PROFILES:
        raise ValueError(
            f"unknown STRIDED_TPU_TEST_PROFILE={profile!r}; "
            f"choose from {sorted(TEST_PROFILES)}"
        )
    from strided_tpu.config import set_config

    set_config(interpret=not ON_GPU, **TEST_PROFILES[profile])


def pytest_report_header(config):
    profile = os.environ.get("STRIDED_TPU_TEST_PROFILE", "default")
    return f"strided_tpu engine profile: {profile}"


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, never
    at import or collection)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with STRIDED_TPU_TEST_DEVICE=gpu)")
    return jax.devices()[0]


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(1234)  # same seed discipline as /root/reference/test/runtests.jl:7
    yield
