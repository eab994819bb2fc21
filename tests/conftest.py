"""Test config: JAX on the CPU with 8 virtual devices, so the sharding
tests exercise multi-device code paths without accelerators (SURVEY.md
§4.4).  A run that sets JAX_PLATFORMS itself keeps it: chip_smoke.py runs
the GPU-marked tests inside its own process, which already holds the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none.  Decided
    here, at run time, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(autouse=True)
def _clear_jax_caches_after_slow(request):
    """Release compiled executables after each slow-tier test.

    The slow tier compiles ~16 large distinct graphs (full renders +
    gradient transposes) in one process; on a small-RAM host the XLA CPU
    compiler's cumulative footprint eventually segfaults mid-compile
    (observed twice at the 13th slow test, which passes alone).  Slow
    tests don't share jit graphs, so dropping the cache between them
    costs nothing and bounds peak memory."""
    yield
    if request.node.get_closest_marker("slow") is not None:
        jax.clear_caches()
