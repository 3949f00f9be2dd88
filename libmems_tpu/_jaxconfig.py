"""Central JAX configuration for libmems_tpu.

64-bit integers are required host-side for seed-mer keys of weight > 15
(up to 63 bits: 2 bits/char * 31 chars + 1 strand bit).  Device kernels
use explicit 32-bit dtypes wherever possible; x64 mode only changes
Python-literal weak-type defaults.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the genome-scale sort/scan pipelines
# compile for seconds to minutes, and the cache turns every repeat
# process (tests, bench, production reruns) into an executable load.
# JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins;
# otherwise the cache sits at a fixed path in the checkout (the path is
# part of the cache key, so it must not move between runs).
_ENV_CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR")
CACHE_DIR = _ENV_CACHE_DIR or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")
if not _ENV_CACHE_DIR:
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
