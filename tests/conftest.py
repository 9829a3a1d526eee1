"""Test configuration.

Tests run on an 8-virtual-device CPU platform: sharding tests exercise real
multi-device program structure without a GPU, and the numeric differential
tests run against fp64 NumPy oracles. The benchmark and the smoke test
(bench.py, chip_smoke.py) run on the GPU; the tests only check here that
they refuse the CPU.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# jax may already have been imported (and read the env) via a pytest plugin;
# override the config value directly before any backend initializes.
jax.config.update("jax_platforms", "cpu")
