"""Test configuration.

A run that does not select the ``gpu`` marker runs on the CPU with 8
virtual devices, so multi-device sharding logic is exercised without a
card.  A run that selects it (``-m gpu``) leaves JAX's platform alone so
it reaches the card; each gpu-marked test decides inside the ``gpu``
fixture whether one is present, and skips with a reason if not.
"""

import os

import numpy as np
import pytest


def _selects_gpu(config) -> bool:
    expr = (config.getoption("markexpr", "") or "").replace(" ", "")
    return "gpu" in expr and "notgpu" not in expr


def pytest_configure(config):
    if _selects_gpu(config):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first JAX device, which must be a GPU (else the test skips)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def ascii_text(rng, size):
    """Random 7-bit ASCII-ish text with realistic letter frequencies."""
    letters = np.frombuffer(b" eetaoinshrdlcumwfgypbvk.,\n", dtype=np.uint8)
    return rng.choice(letters, size=size).tobytes()


@pytest.fixture
def text_1k(rng):
    return ascii_text(rng, 1024)


@pytest.fixture
def text_200k(rng):
    return ascii_text(rng, 200 * 1024)
