"""Test configuration: force the CPU backend with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh so the sharded
paths run on any machine; single-kernel parity tests also run on the
CPU for speed and determinism.  pytest re-execs itself once with
JAX_PLATFORMS=cpu and --xla_force_host_platform_device_count=8 (the
device count must be set before JAX starts).  The re-exec happens in
pytest_configure with global capture suspended so the child inherits
the real stdout/stderr (pytest's fd-level capture would otherwise
swallow all output).

Tests that only a GPU can run carry the `gpu` marker and skip here;
`python chip_smoke.py` runs their paths on the card.
"""

import os
import sys

import pytest


def pytest_configure(config):
    if os.environ.get("LIBMEMS_TPU_TEST_ENV") == "1":
        return
    env = dict(os.environ)
    env["LIBMEMS_TPU_TEST_ENV"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    env["XLA_FLAGS"] = flags

    capman = config.pluginmanager.getplugin("capturemanager")
    if capman is not None:
        capman.suspend_global_capture(in_=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable,
              [sys.executable, "-m", "pytest", *config.invocation_params.args],
              env)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, never while
    test modules are collected)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return jax.devices()[0]
