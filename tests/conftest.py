"""Test environment: force the CPU backend with 8 virtual devices so
multi-device sharding is exercised without GPUs (SURVEY.md §4).

Backend *resolution* is lazy: updating ``jax_platforms`` via the config API
before any device is touched lands the tests on CPU whatever the
environment names.  XLA_FLAGS must be set before the CPU client is
instantiated.  On the CPU the cluster-pair kernel runs in the Pallas
interpreter; ``chip_smoke.py`` runs the same checks compiled on a GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) == 8, jax.devices()
