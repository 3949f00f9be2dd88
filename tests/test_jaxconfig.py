"""Compile-cache location: JAX_COMPILATION_CACHE_DIR when set, else the
fixed <repo>/.jax_cache (checked in fresh interpreters, since the
setting is made once at import)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax, libmems_tpu._jaxconfig as c; "
          "print(jax.config.jax_compilation_cache_dir); print(c.CACHE_DIR)")


def _cache_dirs(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return out[-2:]


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    if env_dir is None:
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
    assert _cache_dirs(None if env_dir is None else want) == [want, want]
