"""Local statistics + histograms: sdev (5x5 RMS), the noise histogram with
the reference's per-tile-column ``break`` semantics, and histogram argmax.

The GLSL histograms are ``imageAtomicAdd`` scatters over a 1-D r32ui image
(shaders/noise_hist.comp).  ``fixed_histogram`` computes the same exact
counts as a factorized one-hot matrix product.

The ``break`` quirk (shaders/noise_hist.comp:30-40): each GPU thread scans a
16x16 tile column-by-column; the first pixel in a tile-column that is 0.0,
out of range (> 0.1) or maps to bin 0 stops that column's scan.  Vectorized:
a pixel contributes iff the inclusive running count of break conditions along
its tile-column segment is zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import MusicaConfig


def img_sdev(img: jnp.ndarray) -> jnp.ndarray:
    """5x5 RMS (not mean-subtracted), zero padding at borders
    (shaders/img_sdev.comp:15-29)."""
    h, w = img.shape[-2], img.shape[-1]
    sq = img * img
    pad = [(0, 0)] * (img.ndim - 2) + [(2, 2), (2, 2)]
    p = jnp.pad(sq, pad)
    tmp = sum(p[..., m:m + h, :] for m in range(5))
    s = sum(tmp[..., :, n:n + w] for n in range(5))
    return jnp.sqrt(s * (1.0 / 25.0))


def _factor(n_bins: int):
    """Split ``n_bins`` into (coarse C, fine F, padded) with C * F = padded.

    Bin ``b`` lives at (b // F, b % F) for any split, so the split changes
    the cost, never the counts.  C = 32 where that divides evenly (2048 bins
    -> 32 x 64, 1024 -> 32 x 32); not yet tuned on the GPU.
    """
    if n_bins % 32 == 0 and 32 <= n_bins // 32 <= 128:
        return 32, n_bins // 32, n_bins
    fine = 128
    while fine > 32 and n_bins % fine != 0:
        fine //= 2
    if n_bins % fine != 0:
        padded = -(-n_bins // 32) * 32
        return padded // 32, 32, padded
    return n_bins // fine, fine, n_bins


# entries per matrix-product chunk: chunk * 128 = 2^24, so a chunk's f32
# partial counts stay exact for weights up to 128
_HIST_CHUNK = 131072


def fixed_histogram(bins_idx: jnp.ndarray, weights: jnp.ndarray,
                    n_bins: int) -> jnp.ndarray:
    """Weighted histogram of int32 ``bins_idx`` (any shape) into ``n_bins``.

    Entries outside [0, n_bins) are dropped, like the reference's
    out-of-range ``imageAtomicAdd``s.  ``weights`` are integers in
    [0, 128] (the pipeline's are 0/1 and trunc(relevance * 100)).
    Returns EXACT int32 counts [n_bins], as the GLSL uint32 atomics give.

    Factorized one-hot matrix product: the bin index splits as
    ``b = c * F + f`` (``_factor``) and

        A[i, c] = w_i * [c_i == c]      (N x C, bf16)
        B[i, f] = [f_i == f]            (N x F, bf16)
        hist    = (A^T @ B).reshape(-1)  (f32 accumulation)

    Exactness: both operands are bf16, which holds 0, 1 and every integer
    up to 256 exactly, so each product is exactly 0 or w_i (TF32 rounding,
    which the GPU may apply to f32 operands, does not arise).  The f32 sums
    are taken over chunks of ``_HIST_CHUNK`` entries, each below 2^24 and
    so exact, and the chunks are summed in int32.

    Measured end to end at 3072^2 on an H100 against an int32 scatter-add
    (the reference's atomics), this was the faster of the two (PERF.md).
    """
    b = bins_idx.reshape(-1)
    w = weights.reshape(-1).astype(jnp.float32)
    w = jnp.where((b >= 0) & (b < n_bins), w, 0.0)
    b = jnp.clip(b, 0, n_bins - 1)
    C, F, _ = _factor(n_bins)
    n = b.shape[0]
    pad_n = -(-max(n, 1) // _HIST_CHUNK) * _HIST_CHUNK
    if pad_n != n:
        b = jnp.pad(b, (0, pad_n - n))
        w = jnp.pad(w, (0, pad_n - n))  # zero weight: padding drops out
    b2 = b.reshape(-1, _HIST_CHUNK)
    w2 = w.reshape(-1, _HIST_CHUNK)
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (1, 1, C), 2)
    iota_f = jax.lax.broadcasted_iota(jnp.int32, (1, 1, F), 2)
    a = jnp.where((b2 // F)[..., None] == iota_c, w2[..., None], 0.0
                  ).astype(jnp.bfloat16)
    bm = ((b2 % F)[..., None] == iota_f).astype(jnp.bfloat16)
    h2 = jax.lax.dot_general(a, bm, (((1,), (1,)), ((0,), (0,))),
                             preferred_element_type=jnp.float32)
    return h2.astype(jnp.int32).sum(axis=0).reshape(-1)[:n_bins]


def coverage_view(sdev: jnp.ndarray, cfg: MusicaConfig):
    """Slice/pad a level image to the histogram dispatch coverage (None when
    the integer-division dispatch covers nothing, src/vk_processing.cpp:2292)."""
    n = sdev.shape[-1]
    tile = cfg.histogram_area_size
    n_pad = -(-n // tile) * tile
    cov = min(n_pad, cfg.hist_coverage) if cfg.quirks else n_pad
    if cov == 0:
        return None
    v = sdev
    if cov > n:
        pad = [(0, 0)] * (v.ndim - 2) + [(0, cov - n), (0, cov - n)]
        v = jnp.pad(v, pad)
    elif cov < n:
        v = v[..., :cov, :cov]
    return v


def noise_bins(sdev: jnp.ndarray, cfg: MusicaConfig):
    """Per-pixel (bin, weight) for the noise histogram including the break
    semantics and dispatch coverage.  sdev is one level's [n, n] image."""
    tile = cfg.histogram_area_size
    v = coverage_view(sdev, cfg)
    if v is None:
        z = jnp.zeros(sdev.shape[:-2] + (0,), jnp.int32)
        return z, z.astype(jnp.float32)
    cov = v.shape[-1]
    # division (not reciprocal-multiply): the GLSL divides by 0.1f and the
    # 1-ulp difference moves pixels across bin boundaries
    adjusted = v / jnp.float32(cfg.max_noise_value)
    bins = (adjusted * jnp.float32(cfg.noise_histogram_bins)
            + jnp.float32(0.5)).astype(jnp.int32)
    brk = (v == 0.0) | (adjusted > 1.0) | (bins == 0)
    # tile-column break: reshape x -> (tx, m), y -> (ty, nn); scan runs along
    # nn.  A pixel survives iff the first break in its 16-lane group comes
    # strictly after it (first-occurrence argmax; equivalent to an
    # inclusive-cumsum == 0 test).
    t = cov // tile
    brk_t = brk.reshape(brk.shape[:-2] + (t * tile * t, tile))
    any_b = brk_t.any(axis=-1)
    first_b = jnp.where(any_b, jnp.argmax(brk_t, axis=-1).astype(jnp.int32), tile)
    lane = jnp.arange(tile, dtype=jnp.int32)
    alive = lane < first_b[..., None]
    w = alive.reshape(v.shape).astype(jnp.float32)
    w = jnp.where(bins < cfg.noise_histogram_bins, w, 0.0)  # bin 2048: OOB atomic
    return bins.reshape(bins.shape[:-2] + (-1,)), w.reshape(w.shape[:-2] + (-1,))


def noise_histogram(sdev: jnp.ndarray, cfg: MusicaConfig) -> jnp.ndarray:
    """Noise histogram of one level's sdev image (shaders/noise_hist.comp):
    the break/coverage masks of ``noise_bins``, then ``fixed_histogram``."""
    bins, w = noise_bins(sdev, cfg)
    if bins.shape[-1] == 0:
        return jnp.zeros((cfg.noise_histogram_bins,), jnp.int32)
    return fixed_histogram(bins, w, cfg.noise_histogram_bins)


def analysis_noise_hists(sdevs, cfg: MusicaConfig):
    """Noise histogram + argmax for every analysis level.

    Returns ``(hists, max_bins)`` dicts keyed by level."""
    levels = list(cfg.analysis_levels)
    hists = {i: noise_histogram(sdevs[i], cfg) for i in levels}
    maxb = {i: histogram_max(hists[i])[1] for i in levels}
    return hists, maxb


def histogram_max(hist: jnp.ndarray):
    """(max_value, max_bin); strict > keeps the first maximum, and an
    all-zero histogram yields bin 0 (shaders/img_histogram_max.comp:17-31).
    jnp.argmax returns the first occurrence, matching exactly."""
    return hist.max(axis=-1), jnp.argmax(hist, axis=-1).astype(jnp.int32)
