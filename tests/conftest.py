"""Test config: the CPU backend with 8 virtual devices (multi-device tests).

Must run before any jax import (SURVEY.md §4 test strategy item 3). Kernel
tests run the Pallas kernels in interpret mode on the CPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
