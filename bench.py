"""Time the MUSICA pipeline on one GPU: the single-image program and the
batch program (``process_batch_jit``) on a synthetic 3072^2 thorax.

    python bench.py

One process.  Compilation and one warm-up call per program are set-up
time; every timed call ends in ``block_until_ready``.  Prints the card's
name and power limit (``nvidia-smi``), then one JSON line with the device
as JAX reports it and the median and minimum times.  Exits non-zero, with
no result, when JAX's first device is not a GPU.
"""

from __future__ import annotations

import json
import statistics
import sys
import time


def time_call(fn, args, iters: int) -> list:
    """Seconds of ``iters`` calls of ``fn(*args)``, each waited for."""
    import jax

    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def measure(size: int, batch: int, iters: int) -> dict:
    """Set up, check and time both programs on the default device."""
    import jax.numpy as jnp
    import numpy as np

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph

    cfg = MusicaConfig(image_size=size)
    x = jnp.asarray(synthetic_radiograph(size, "thorax"))
    xb = jnp.stack([x] * batch)

    t0 = time.perf_counter()
    single = np.asarray(musica.process_jit(x, cfg))
    setup_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = np.asarray(musica.process_batch_jit(xb, cfg))
    setup_batch = time.perf_counter() - t0
    if not (outs == single[None]).all():
        raise RuntimeError("batch outputs differ from the single-image output")

    ts = time_call(lambda a: musica.process_jit(a, cfg), (x,), iters)
    tb = time_call(lambda a: musica.process_batch_jit(a, cfg), (xb,),
                   max(1, iters // 4))
    ms = 1e3
    return {
        "size": size, "batch": batch, "iters": iters,
        "setup_s": {"single": setup_single, "batch": setup_batch},
        "single_ms": {"median": statistics.median(ts) * ms,
                      "min": min(ts) * ms},
        "batch_ms_per_image": {"median": statistics.median(tb) * ms / batch,
                               "min": min(tb) * ms / batch},
    }


SIZE = 3072
BATCH = 16  # an earlier platform's choice, not yet re-tuned on the GPU
ITERS = 20


def main() -> int:

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import device
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils.compile_cache import enable_compile_cache

    try:
        device.require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = device.card_line()
    print(f"card: {card}", flush=True)
    res = measure(SIZE, BATCH, ITERS)
    res["device"] = device.device_record()
    res["card"] = card
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
