"""Process set-up shared by the entry points (bench.py, chip_smoke.py,
cli.py): the persistent compile cache and the card's identity."""

import os
import subprocess

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache():
    """Keep JAX's persistent compile cache where JAX_COMPILATION_CACHE_DIR
    says, or at <repo>/.cache/jax_cache when it is unset (a fixed path:
    the path is part of the cache key).  Returns the directory."""
    cache = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
             or os.path.join(_REPO, ".cache", "jax_cache"))
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return cache


def gpu_name_and_power_limit():
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one line
    each, as nvidia-smi prints it.  A card below its top power limit runs
    slower under load, so every recorded time carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
