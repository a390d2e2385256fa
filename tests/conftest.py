"""Test harness setup: force JAX onto CPU with 8 virtual devices so the
multi-device sharding paths are exercised without accelerators (the
standard pjit/shard_map emulation recipe, SURVEY.md section 4).  Tests
that need a GPU carry the `gpu` marker and the `gpu_card` fixture below,
which skips them where there is no card."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="session")
def _assert_cpu():
    assert jax.devices()[0].platform == "cpu", jax.devices()
    yield


@pytest.fixture
def gpu_card():
    """Skip unless an NVIDIA GPU is present.  Decided here, at test time,
    never at import; the check stays off JAX, which this process holds on
    the CPU, so `gpu` tests drive the card from a subprocess."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")
