"""Test harness config: run JAX on CPU with 8 virtual devices.

Multi-chip sharding tests use a virtual 8-device mesh on the host platform —
the standard JAX trick for testing pod-slice code without a pod (the driver
separately dry-runs the multi-chip path via __graft_entry__.dryrun_multichip).

The platform is forced to the CPU through the environment AND jax.config,
so the suite never touches an accelerator even where one is present; the
GPU paths are exercised on the card by chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
