"""Test configuration: run JAX on CPU with 8 virtual devices so sharding
tests exercise a multi-device mesh without accelerators.

The platform is forced through jax.config as well as os.environ, which also
holds when jax was imported before this file ran.
"""

import os

# must be set before the CPU backend is initialized for the 8-device mesh
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import (  # noqa: E402
    synthetic_radiograph,
)


def pytest_configure(config):
    assert jax.devices()[0].platform == "cpu", jax.devices()


@pytest.fixture(scope="session")
def phantom_512():
    return synthetic_radiograph(512, "thorax")


@pytest.fixture(scope="session")
def phantom_256():
    return synthetic_radiograph(256, "knee")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def pytest_collection_modifyitems(config, items):
    """Skip `slow`-marked tests by default (suite budget: < 10 min on the
    8-virtual-CPU mesh).  Opt in with `-m slow` or MUSICA_RUN_SLOW=1; the
    slow set re-covers scale points (1792 ragged sharding) whose quirk
    surface is already exercised at smaller sizes in the default run."""
    if os.environ.get("MUSICA_RUN_SLOW") or "slow" in config.option.markexpr:
        return
    skip = pytest.mark.skip(reason="slow: opt in with -m slow or MUSICA_RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


# Persistent XLA compile cache, by the repository's one rule
# (utils/compile_cache.py): $JAX_COMPILATION_CACHE_DIR when set, else
# <checkout>/.jax_cache.  The suite is dominated by full-pipeline compiles,
# so repeat runs are much faster.
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()
