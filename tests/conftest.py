"""Test configuration: the CPU backend with an 8-device virtual mesh.

The device compute path is validated here on the CPU (float64 available);
the multi-device sharding tests use the 8 virtual devices.  The GPU lane
(tests/test_gpu.py, marker `gpu`) runs on the card when the platform is
chosen from outside, e.g. `JAX_PLATFORMS=cuda pytest -m gpu tests/test_gpu.py`;
with JAX_PLATFORMS unset or set to cpu its tests skip.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

# The suite is dominated by XLA:CPU compiles of the big fused programs,
# which are identical run-to-run.
enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def fixture_dir():
    return os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="session")
def gaussvol_system(fixture_dir):
    """The 264-atom reference fixture as an AGBNPParams + positions."""
    from openmm_agbnp_jax.io.gaussvol_dat import load_gaussvol_dat
    from openmm_agbnp_jax.models.oracle import AGBNPParams

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(fixture_dir, "gaussvol.dat"))
    params = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                         charge=charge, ishydrogen=ish)
    return params, pos
