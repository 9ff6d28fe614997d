"""Gradation (tone) phase: relevance-weighted histogram, histogram-driven
tone-curve synthesis, and the final LUT application.

The reference's gradation_curve_generate is a single-thread GPU kernel with
three sequential scans over the 1024-bin histogram
(shaders/gradation_curve_generate.comp:49-182).  Here those scans become
vectorized prefix reductions:

* weighted mean      -> masked dot products (uint32 wrap-around preserved);
* peak in [10, mean) -> masked argmax (strict >, first occurrence);
* t0 window walk-down / t1 walk-up -> contiguous-run tests via cumulative
  sums of the violated condition.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import MusicaConfig
from .curves import bezier_points
from .stats import fixed_histogram

F32 = jnp.float32
U32 = jnp.uint32


def gradation_bins(recon: jnp.ndarray, relevant: jnp.ndarray, cfg: MusicaConfig):
    """Per-pixel (bin, weight) with the tile-`return` quirk
    (shaders/gradation_histogram.comp:20-33): the whole 16x16 tile scan
    (column-major) aborts at the first pixel == 0.0.  bin = trunc(v * 1024);
    weight = trunc(relevant * 100); OOB bins are dropped atomics."""
    n = recon.shape[-1]
    tile = cfg.histogram_area_size
    cov = -(-n // tile) * tile  # ceil dispatch (src/vk_processing.cpp:2492)
    v, r = recon, relevant
    if cov > n:
        pad = [(0, 0)] * (v.ndim - 2) + [(0, cov - n), (0, cov - n)]
        v = jnp.pad(v, pad)
        r = jnp.pad(r, pad)
    bins = (v * F32(cfg.grad_histogram_bins)).astype(jnp.int32)  # trunc to zero
    t = cov // tile
    zero = (v == 0.0).reshape(v.shape[:-2] + (t, tile, t, tile))
    # a pixel at tile offset (m, n) survives iff no zero exists in any earlier
    # tile column m' < m AND none at rows <= n of its own column -- equivalent
    # to the flatten-scan cumsum but transpose-free (first-occurrence argmax
    # instead of cumsums):
    col_zero = zero.any(axis=-1)                                     # (tx, m, ty)
    any_c = col_zero.any(axis=-2)                                    # (tx, ty)
    first_zc = jnp.where(any_c, jnp.argmax(col_zero, axis=-2), tile)
    m_idx = jnp.arange(tile, dtype=jnp.int32)
    # a column m may still run if the first zero-column is m itself or later
    no_prev = m_idx[None, :, None] <= first_zc[..., :, None, :]      # (tx, m, ty)
    first_zn = jnp.where(col_zero, jnp.argmax(zero, axis=-1), tile)  # (tx, m, ty)
    n_idx = jnp.arange(tile, dtype=jnp.int32)
    ok_in_col = n_idx < first_zn[..., None]                          # (tx, m, ty, n)
    alive = (no_prev[..., None] & ok_in_col).reshape(v.shape)
    w = jnp.where(alive, (r * F32(100.0)).astype(jnp.int32).astype(F32), 0.0)
    w = jnp.where((bins >= 0) & (bins < cfg.grad_histogram_bins), w, 0.0)
    return bins.reshape(bins.shape[:-2] + (-1,)), w.reshape(w.shape[:-2] + (-1,))


def gradation_histogram(recon: jnp.ndarray, relevant: jnp.ndarray,
                        cfg: MusicaConfig) -> jnp.ndarray:
    """Relevance-weighted gradation histogram
    (shaders/gradation_histogram.comp): the tile-``return`` masks of
    ``gradation_bins``, then ``fixed_histogram``."""
    bins, w = gradation_bins(recon, relevant, cfg)
    return fixed_histogram(bins, w, cfg.grad_histogram_bins)


def gradation_curve(hist: jnp.ndarray, cfg: MusicaConfig):
    """Tone curve from the gradation histogram
    (shaders/gradation_curve_generate.comp:49-182).

    Returns (px[22], py[22], (t0, ta, t1)).  Quirks preserved: uint32
    wrap-around of the weighted-mean accumulators, integer division for the
    mean bin, thresholds truncated to uint.
    """
    bins = cfg.grad_histogram_bins
    lowest = cfg.grad_lowest_relevant_bin
    counts = (hist.astype(U32) // U32(100)).astype(U32)
    idx = jnp.arange(bins, dtype=jnp.int32)
    rel = idx >= lowest

    # mean (uint32 arithmetic wraps)
    mean_count = jnp.sum(jnp.where(rel, counts * idx.astype(U32), U32(0)),
                         dtype=U32)
    mean_sum = jnp.sum(jnp.where(rel, counts, U32(0)), dtype=U32)
    mean_bin = jnp.where(mean_sum == 0, U32(0), mean_count // jnp.maximum(mean_sum, U32(1)))
    mean_hist_pos = mean_bin.astype(F32) / F32(bins)
    mean_limit = (mean_hist_pos * F32(bins)).astype(jnp.int32)

    # peak in [lowest, mean_limit)
    counts_i = counts.astype(jnp.int32)
    in_range = rel & (idx < mean_limit)
    vals = jnp.where(in_range, counts_i, 0)
    max_count = vals.max()
    max_position = jnp.where(max_count > 0, jnp.argmax(vals).astype(jnp.int32), 0)

    low_threshold = (max_count.astype(F32) * F32(cfg.grad_low_threshold_frac)
                     ).astype(jnp.int32)

    # t0: largest contiguous >=threshold run ending at max_position, down to 1
    ok = counts_i >= low_threshold
    bad_up_to_m = jnp.where(~ok & (idx <= max_position), 1, 0)
    c = jnp.cumsum(bad_up_to_m)
    suffix = c[max_position] - jnp.where(idx > 0, c[idx - 1], 0)
    a = (suffix == 0) & (idx >= 1) & (idx <= max_position)
    t0_found = jnp.any(a)
    t0_pos = jnp.argmax(a).astype(jnp.int32)  # first True = smallest index
    t0 = jnp.where(t0_found, t0_pos.astype(F32) * F32(1.0 / bins), F32(0.0))

    # t1: longest contiguous >0 run starting at max_position, upward
    ok2 = counts_i > 0
    bad_from_m = jnp.where(~ok2 & (idx >= max_position), 1, 0)
    d = jnp.cumsum(bad_from_m)
    b_run = (d == 0) & (idx >= max_position)
    t1_found = jnp.any(b_run)
    t1_pos = jnp.where(t1_found,
                       jnp.max(jnp.where(b_run, idx, -1)).astype(jnp.int32), 0)
    t1 = jnp.where(t1_found, t1_pos.astype(F32) * F32(1.0 / bins), F32(0.0))

    ta = max_position.astype(F32) * F32(1.0 / bins)

    t0 = jnp.maximum(t0 - F32(cfg.grad_t0_backoff), F32(0.0))
    t1 = jnp.minimum(t1, F32(1.0))

    m = F32(cfg.grad_slope)
    y_m = F32(cfg.grad_y_mid)
    zero = F32(0.0)
    one = F32(1.0)

    tf_raw = -(F32(0.5) / m) + ta
    tf = jnp.maximum(tf_raw, t0)
    seg1 = bezier_points((t0, zero), (tf, zero), (ta, y_m), False)
    m2 = jnp.where(tf == t0, y_m / (ta - tf), m)  # recompute slope if clipped
    ts = (y_m / m2) + ta
    seg2 = bezier_points((ta, y_m), (ts, one), (t1, one), False)

    px = jnp.concatenate([jnp.zeros((1,), F32), seg1[0], seg2[0], jnp.ones((1,), F32)])
    py = jnp.concatenate([jnp.zeros((1,), F32), seg1[1], seg2[1], jnp.ones((1,), F32)])
    return px, py, (t0, ta, t1)
