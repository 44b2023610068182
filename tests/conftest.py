"""Test harness config: run everything on a virtual 8-device CPU mesh.

Mirrors the reference test strategy's "fake backend" idea (reference:
tests/test_rollouts.py uses pure-JAX fake sims); multi-device sharding logic
is exercised on forced host CPU devices, so no accelerator is required. The
platform is pinned through ``jax.config`` as well as the environment, so the
tests run on the CPU even on a machine with a GPU; what needs the GPU runs
through ``chip_smoke.py``.
"""

import os

# Must be set before any backend is initialized.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
