"""Multi-device scaling via jax.sharding + GSPMD.

The reference has no distribution at all (single Vulkan compute queue,
SURVEY.md section 2.5); the scale-out here is:

* **data parallelism** over the image batch (axis ``"data"``): every image is
  processed independently, so no cross-image communication exists and scaling
  across devices is embarrassingly parallel;
* **spatial parallelism** over image rows (axis ``"space"``): for images (or
  batch-per-device memory budgets) that exceed one device, the input is sharded
  along the first image axis.  The 5x5 convolutions then require a 2-row halo
  and the histograms a global reduction -- both of which GSPMD derives
  automatically from the sharding annotations (collective-permute halos,
  all-reduce histogram partials) with the whole pipeline written as plain
  jnp; no hand-written collectives, no manual ring schedules.

The two compose on a 2-D ``(data, space)`` mesh.  Each device runs the
unbatched single-image program (``lax.map`` over its local batch).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MusicaConfig
from ..models import musica


def make_mesh(n_data: Optional[int] = None, n_space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, space) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_space
    used = n_data * n_space
    dev_arr = np.array(devices[:used]).reshape(n_data, n_space)
    return Mesh(dev_arr, axis_names=("data", "space"))


def process_sharded(imgs_u16: jnp.ndarray, cfg: MusicaConfig, mesh: Mesh,
                    outputs: Sequence[str] = ("out_u8",)):
    """Batched pipeline with batch sharded over ``data`` and image rows over
    ``space``.  Input [B, n, n] uint16, output [B, n-2m, n-2m] uint8.

    ``outputs`` selects which musica_forward results to return (a single
    array for one name, else a tuple in order).  Variant outputs that are
    not consumed are dead-code-eliminated by XLA, so e.g. the CLAHE path is
    only *executed* under sharding when ``"clahe_graded"`` is requested.

    Both mesh shapes run the UNBATCHED single-image program (``lax.map``
    over the local batch):

    * ``space == 1``: fully-manual ``shard_map`` over ``data``; each device
      runs the single-image program.
    * ``space > 1``: partial-manual ``shard_map`` (manual over ``data``,
      GSPMD-auto over ``space``): the per-image body is annotated with a
      ``P("space", None)`` row sharding and GSPMD inserts the 2-row conv
      halo exchanges and histogram all-reduces.
    """
    outputs = tuple(outputs)
    run = _sharded_program(cfg, mesh, outputs)
    out = run(jax.device_put(imgs_u16,
                             NamedSharding(mesh, P("data", "space", None))))
    return out[0] if len(outputs) == 1 else out


@lru_cache(maxsize=16)
def _sharded_program(cfg: MusicaConfig, mesh: Mesh, outputs: tuple):
    """The jitted program of ``process_sharded``, built once per (config,
    mesh, outputs) so that repeated calls reuse its compilation."""
    out_specs = tuple(P("data", None, None) for _ in outputs)

    def per_image(im):
        r = musica.musica_forward(im, cfg)
        return tuple(r[k] for k in outputs)

    if mesh.shape["space"] == 1:
        # pure data parallelism: shard_map + per-device lax.map runs the
        # single-image program on each device and loops any extra local
        # batch sequentially
        return jax.jit(jax.shard_map(
            lambda b: jax.lax.map(per_image, b),
            mesh=mesh, in_specs=P("data", None, None),
            out_specs=out_specs))

    # data x space: manual over `data`, auto (GSPMD) over `space`.  The body
    # sees the local [B/data, n, n] shard still row-sharded over `space`;
    # lax.map keeps the unbatched program per image while GSPMD partitions
    # each image's rows across the `space` subgroup.
    def body(b):
        b = jax.lax.with_sharding_constraint(b, P(None, "space", None))
        return jax.lax.map(per_image, b)

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("data", None, None),
        out_specs=out_specs, axis_names={"data"}))


def throughput_step(cfg: MusicaConfig, mesh: Mesh, batch_per_device: int = 1):
    """Compile a steady-state throughput step: [B_global, n, n] -> checksum.

    Returns (fn, example_batch).  The scalar output forces full execution
    while avoiding a large device->host transfer in benchmarks.
    """
    b_global = batch_per_device * mesh.shape["data"]
    in_spec = NamedSharding(mesh, P("data", "space", None))

    if mesh.shape["space"] == 1:
        @jax.jit
        @partial(jax.shard_map, mesh=mesh, in_specs=P("data", None, None),
                 out_specs=P())
        def step(b):
            out = jax.lax.map(
                lambda im: musica.musica_forward(im, cfg)["out_u8"], b)
            return jax.lax.psum(out.astype(jnp.uint32).sum(), "data")
    else:
        # same hybrid formulation as process_sharded: manual over `data`,
        # GSPMD-auto row sharding over `space`, unbatched program via lax.map
        def body(b):
            b = jax.lax.with_sharding_constraint(b, P(None, "space", None))
            out = jax.lax.map(
                lambda im: musica.musica_forward(im, cfg)["out_u8"], b)
            return jax.lax.psum(out.astype(jnp.uint32).sum(), "data")

        step = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=P("data", None, None),
            out_specs=P(), axis_names={"data"}))

    rng = np.random.default_rng(0)
    example = rng.integers(0, 65535, (b_global, cfg.image_size, cfg.image_size),
                           dtype=np.uint16)
    return step, jax.device_put(jnp.asarray(example), in_spec)
