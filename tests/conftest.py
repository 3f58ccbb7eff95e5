"""Test harness configuration.

Mirrors the reference's test strategy (SURVEY.md section 4): every sharded
op is validated against a single-device reference on the assembled global
array. Multi-device is simulated with 8 virtual CPU devices (the analogue of
the reference CI's ``mpiexec -n 4`` on one runner,
/root/reference/Makefile:90-92). Tests that need an NVIDIA GPU carry the
``gpu`` marker and take the ``gpu_device`` fixture, which skips them when
no GPU is present.
"""

import os
import sys

# CPU with 8 virtual devices, set BEFORE importing jax anywhere. On a GPU
# host, ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu`` runs the
# card's tests.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

# double precision tier of the reference test matrix needs x64
jax.config.update("jax_enable_x64", True)
# persistent compile cache: the suite is compilation-dominated
configure_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(params=["single", "double"])
def precision(request):
    return request.param


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX sees none. Decided
    here, at test time, never while a test module is imported."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu)")
    return gpus[0]
