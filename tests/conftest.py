"""Test configuration.

By default the suite runs on an 8-device virtual CPU mesh, so multi-device
sharding paths are exercised without an accelerator. ``--on-gpu`` leaves
the platform to JAX (the GPU on a machine that has one) and runs the tests
marked ``gpu``, which otherwise skip:

    python -m pytest tests/ --on-gpu -m gpu
"""

import os

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--on-gpu", action="store_true", default=False,
        help="leave the JAX platform to JAX (GPU) and run tests marked gpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; runs only with --on-gpu")
    if config.getoption("--on-gpu"):
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless the run was started with --on-gpu
    and JAX's default backend really is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if not request.config.getoption("--on-gpu"):
        pytest.skip("needs an NVIDIA GPU: run with --on-gpu on the card")
    import jax

    if jax.default_backend() != "gpu":
        pytest.fail(f"--on-gpu given but JAX's backend is "
                    f"{jax.default_backend()!r}")
