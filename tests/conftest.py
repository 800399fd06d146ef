"""Test harness config: the CPU backend (forced in-process, so the suite runs
on the CPU whatever accelerator the machine has), f64, and 8 virtual devices
for sharding tests. Tests marked `gpu` need the card and skip here."""
import os

_flag = "--xla_force_host_platform_device_count=8"
_existing = os.environ.get("XLA_FLAGS", "")
if _flag not in _existing:
    os.environ["XLA_FLAGS"] = (_existing + " " + _flag).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else the fixed
# <checkout>/.jax_cache): the suite is dominated by jit compiles — warm-cache
# reruns are several times faster
from tensorkrylov.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache(min_compile_secs=0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none (decided at
    run time, never at import: every xdist worker must collect the same
    tests)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run on the card via chip_smoke.py)")
