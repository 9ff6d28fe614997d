"""CLAHE gradation variant (reference: ``ENABLE_CLAHE``, compiled out by
default -- include/vk_processing.h:13; shaders/clahe_histogram.comp,
clahe_grad_curve.comp, clahe_grad_curve_apply.comp).

Per 4x4 image tile: a 256-bin histogram of relevance-masked pixels, clipped
at 1/32 with the clipped mass redistributed, cumulated into a CDF used as a
per-tile tone LUT; application blends the LUTs of up to 4 neighboring tiles
bilinearly by distance to the tile centers.

Undefined-behavior notes (documented deviations):
  * the reference binds the f32 relevance image to an ``r16`` storage image
    (clahe_histogram.comp:12) -- a Vulkan format mismatch; we read the float
    value directly and keep the ``relevant == 1.0`` test;
  * at edge tiles the GLSL converts a negative float tile coordinate to
    uint (clahe_grad_curve_apply.comp:79), which is undefined; we use the
    saturating (clamp-to-0) behavior of real hardware.
"""

from __future__ import annotations


import jax.numpy as jnp

from ..config import MusicaConfig
from .stats import fixed_histogram

F32 = jnp.float32


def clahe_histograms(recon: jnp.ndarray, relevant: jnp.ndarray,
                     cfg: MusicaConfig) -> jnp.ndarray:
    """[tiles, tiles, bins] histogram of pixels with relevant == 1.0.

    bin = int(pixel * (bins-1) + 0.5) (clahe_histogram.comp:20); OOB bins
    (pixel outside [0, ~1]) are dropped atomics.
    """
    t = cfg.clahe_tiles
    bins = cfg.clahe_bins
    n = recon.shape[-1]
    b = (recon * F32(bins - 1) + F32(0.5)).astype(jnp.int32)
    w = jnp.where(relevant == 1.0, 1.0, 0.0)
    # tile id per pixel: uint(x / n * tiles)
    xs = (jnp.arange(n, dtype=F32) / F32(n) * F32(t)).astype(jnp.int32)
    tile_id = xs[:, None] * t + xs[None, :]
    joint = b + tile_id * bins  # composite bin: tile * bins + intensity
    w = jnp.where((b >= 0) & (b < bins), w, 0.0)
    joint = jnp.where((b >= 0) & (b < bins), joint, 0)
    h = fixed_histogram(joint, w, t * t * bins)
    return h.reshape(t, t, bins)


def clahe_curves(hists: jnp.ndarray, cfg: MusicaConfig):
    """Per-tile clipped-CDF LUT (clahe_grad_curve.comp:22-97).

    Returns (px[bins], py[t, t, bins]): x grid is shared (i/bins, last
    clamped to 1.0); y is the redistributed cumulative distribution.
    """
    bins = cfg.clahe_bins
    counts = hists.astype(F32)
    total = counts.sum(axis=-1, keepdims=True)
    norm = counts / total  # tile with zero relevant pixels -> nan, as GLSL 0/0
    clip = F32(cfg.clahe_clip_limit)
    clipped = jnp.minimum(norm, clip)
    excess = (norm - clipped).sum(axis=-1, keepdims=True)
    redist = clipped + excess / F32(bins)
    cdf = jnp.cumsum(redist, axis=-1)
    px = jnp.arange(bins, dtype=F32) / F32(bins)
    px = px.at[bins - 1].set(1.0)
    return px, cdf


def _lut_eval(px: jnp.ndarray, py_flat: jnp.ndarray, tile_idx: jnp.ndarray,
              x: jnp.ndarray, bins: int) -> jnp.ndarray:
    """Evaluate the per-tile LUT at x with the GLSL getY semantics on the
    uniform grid (exact-match, segment interp, out-of-range -> 0)."""
    # segment index: largest i with px[i] <= x; px uniform (i/bins) except
    # px[bins-1] == 1.0
    i = jnp.clip((x * F32(bins)).astype(jnp.int32), 0, bins - 2)
    x1 = i.astype(F32) / F32(bins)
    is_last = i == bins - 2
    x2 = jnp.where(is_last, F32(1.0), (i + 1).astype(F32) / F32(bins))
    flat1 = tile_idx * bins + i
    y1 = py_flat[flat1]
    y2 = py_flat[flat1 + 1]
    m = (y2 - y1) / (x2 - x1)
    val = m * (x - x1) + y1
    in_range = (x >= 0.0) & (x <= 1.0)
    exact_last = x == 1.0
    val = jnp.where(exact_last, py_flat[tile_idx * bins + bins - 1], val)
    return jnp.where(in_range, val, 0.0)


def clahe_apply(recon: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray,
                cfg: MusicaConfig) -> jnp.ndarray:
    """Bilinear blend of neighboring tile LUTs
    (clahe_grad_curve_apply.comp:38-160)."""
    t = cfg.clahe_tiles
    bins = cfg.clahe_bins
    n = recon.shape[-1]
    tile_size = n // t  # GRID_TILE_SIZE integer division
    py_flat = py.reshape(-1)

    coord = jnp.arange(n, dtype=F32) / F32(tile_size)
    base = jnp.floor(coord).astype(jnp.int32).astype(F32) + F32(0.5)
    diff = coord - base  # in (-0.5, 0.5]
    sgn = jnp.sign(diff).astype(jnp.int32)

    base_i = jnp.floor(base).astype(jnp.int32)
    nb_i = jnp.clip(base_i + sgn, 0, t - 1)  # saturating uint conversion
    base_i = jnp.clip(base_i, 0, t - 1)

    # per-axis weights: 1 - |tileCenter - coord|
    w_base = 1.0 - jnp.abs(base - coord)
    nb_center = (base_i + sgn).astype(F32) + F32(0.5)
    w_nb = 1.0 - jnp.abs(nb_center - coord)

    zero = diff == 0.0

    bx, nx = base_i[:, None], nb_i[:, None]
    by, ny = base_i[None, :], nb_i[None, :]
    wbx, wnx = w_base[:, None], w_nb[:, None]
    wby, wny = w_base[None, :], w_nb[None, :]
    zx, zy = zero[:, None], zero[None, :]

    def ev(tx, ty):
        return _lut_eval(px, py_flat, tx * t + ty, recon, bins)

    g_bb = ev(bx + jnp.zeros_like(by), by + jnp.zeros_like(bx))
    g_nb = ev(nx + jnp.zeros_like(by), by + jnp.zeros_like(nx))
    g_bn = ev(bx + jnp.zeros_like(ny), ny + jnp.zeros_like(bx))
    g_nn = ev(nx + jnp.zeros_like(ny), ny + jnp.zeros_like(nx))

    # case diff.x == 0 and diff.y == 0: single tile
    v_center = g_bb
    # case diff.x == 0: blend along y
    v_x0 = wby * g_bb + wny * g_bn
    # case diff.y == 0: blend along x
    v_y0 = wbx * g_bb + wnx * g_nb
    # general 4-tile bilinear
    v_4 = (wbx * wby * g_bb + wnx * wby * g_nb
           + wbx * wny * g_bn + wnx * wny * g_nn)

    return jnp.where(zx & zy, v_center,
                     jnp.where(zx, v_x0, jnp.where(zy, v_y0, v_4)))


def clahe_grade(recon: jnp.ndarray, relevant: jnp.ndarray,
                cfg: MusicaConfig) -> jnp.ndarray:
    """Full CLAHE gradation: histograms -> clipped CDF LUTs -> blended apply.
    The apply's LUT gathers read a [tiles, tiles, bins] table small enough
    to stay in cache."""
    h = clahe_histograms(recon, relevant, cfg)
    px, py = clahe_curves(h, cfg)
    return clahe_apply(recon, px, py, cfg)
