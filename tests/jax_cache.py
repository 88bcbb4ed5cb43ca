"""A disk cache of compiled JAX programs for the port's parity tests,
under `build/jax_cache` of the checkout (git-ignored).

The port's test files hold the port to JAX programs that several files
compile alike, at the same picture sizes and settings; the JAX package's
own test files run in the same worker processes.  With the cache each
program is compiled once per checkout, and a program compiled again
after `tests/conftest.py` frees the in-memory executables at the end of
a module (or in another worker, or in a later run) is read back from
disk.  Importing this module turns the cache on for the process.  The
cache is bounded, which makes JAX take a file lock around each read and
write: the workers of one run share it safely.
"""
import os

import jax
from jax._src import compilation_cache

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "jax_cache")
MAX_BYTES = 4 << 30


def enable():
    if jax.config.jax_compilation_cache_dir == CACHE_DIR:
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_compilation_cache_max_size", MAX_BYTES)
    # a program compiled before this import has already decided, for the
    # process, that there is no cache
    compilation_cache.reset_cache()


enable()
