"""MUSICA (MUlti-Scale Image Contrast Amplification) framework in JAX.

A from-scratch JAX/XLA re-design of the Vulkan-compute MUSICA X-ray
enhancement pipeline and its metamorphic-testing harness (reference:
MatteoSoldini/metamorphic_testing_of_the_MUSICA_Algorithm_for_x_ray_image_processing,
"maverick").  The reference's ~100 per-kernel Vulkan pipeline objects and
binary-semaphore DAG collapse into one pure, jit-compiled function
(`models.musica.process`); XLA does the scheduling the semaphores did.

Top-level layout
----------------
- ``config``    : runtime configuration (replaces the reference's #defines,
                  ``include/vk_processing.h:13-49``)
- ``ops``       : the 24 compute kernels re-designed as JAX ops
- ``models``    : pipeline assembly (jit) + pure-NumPy golden model (the
                  bit-semantics oracle, mirroring the GLSL quirks)
- ``parallel``  : batch / mesh sharding (shard_map + GSPMD) over devices
- ``utils``     : raw/BMP IO (native C++ codec with Python fallback),
                  debug dumps, stage timing, compile-cache placement,
                  device reporting
- ``testing``   : metamorphic-testing harness (perturbations, similarity
                  metrics, CSV campaign, slope analysis)
"""

from . import config  # noqa: F401

__version__ = "0.1.0"

# Short import alias: `import musica_tpu` is provided by the repo-root shim.
