"""Test configuration.

Tests run on a virtual 8-device CPU platform: the multi-device sharding
tests need several devices, and no unit test may depend on an accelerator.
Runs on the GPU go through ``chip_smoke.py``.
"""

import os

# Both must be set before jax is imported anywhere in the process.
os.environ["JAX_PLATFORMS"] = "cpu"
_DEVICE_FLAG = "--xla_force_host_platform_device_count=8"
if _DEVICE_FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " " + _DEVICE_FLAG

import jax

jax.config.update("jax_enable_x64", True)

if len(jax.devices()) < 8:
    raise RuntimeError(
        f"test suite requires 8 virtual CPU devices, got {len(jax.devices())} "
        f"({jax.devices()}); the multi-device tests must not silently skip"
    )

import pytest


# A checkout of the reference (vandenheuvel/relp) where RELP_REFERENCE_ROOT
# points, else the git-ignored ``reference/`` inside this checkout.
REFERENCE_ROOT = os.environ.get(
    "RELP_REFERENCE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "reference"),
)


def reference_problem(suite: str, name: str) -> str:
    """Path of a problem file shipped with the reference's test suites.

    The reference's netlib/miplib/burkardt/unicamp/cook data is read from
    its checkout; tests that need it are skipped when it is absent.
    """
    path = os.path.join(REFERENCE_ROOT, "tests", suite, "problem_files", name)
    if not os.path.exists(path):
        pytest.skip(f"reference problem file not available: {path}")
    return path


@pytest.fixture
def cpu_config():
    from relp_tpu.config import SolverConfig

    return SolverConfig(pad_to=8, chunk_size=50, refactor_period=50)
