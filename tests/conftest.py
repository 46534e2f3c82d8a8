"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
are exercised without GPUs (`xla_force_host_platform_device_count`, per
SURVEY.md §4d).  Must be set before JAX initializes its backends.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE_DIR = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_dir():
    if not REFERENCE_DIR.exists():
        pytest.skip("reference repository not mounted")
    return REFERENCE_DIR
