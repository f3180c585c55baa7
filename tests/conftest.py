import os

# Unit tests run on the CPU, with 8 virtual devices for the sharding
# tests, unless JAX_PLATFORMS names another backend: then the card
# tests run on that backend in one process, e.g.
#   JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -p no:xdist
_ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu")
if _ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

if _ON_CPU:
    jax.config.update("jax_platforms", "cpu")

from kasa_tpu.utils.compcache import enable_compilation_cache

enable_compilation_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda -m gpu")
    return devs[0]
