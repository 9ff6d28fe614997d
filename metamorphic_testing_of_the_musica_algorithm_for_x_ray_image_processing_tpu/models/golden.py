"""Pure-NumPy golden model of the MUSICA pipeline.

This is the *semantic oracle* for the JAX implementation: a direct,
readable, float32-exact transcription of what the reference's 24 GLSL compute
shaders do (``/root/reference/shaders/*.comp``), including their quirks
(documented per function).  Every JAX op in ``ops/`` is unit-tested against
the function here with the same name.

All arrays are float32 unless noted; images are indexed ``[x, y]`` matching
the GLSL ``texelCoord.xy`` convention (the pipeline is x/y-symmetric except
for the histogram tile-scan quirks, so we keep the shader's own axis order:
axis 0 = x, axis 1 = y; the inner histogram scan runs along axis 1).
"""

from __future__ import annotations

import math

import numpy as np

from ..config import MusicaConfig

F = np.float32


# ----------------------------------------------------------------------
# normalize phase
# ----------------------------------------------------------------------

def img_sqrt(img_u16: np.ndarray) -> np.ndarray:
    """Variance-stabilizing sqrt (shaders/img_sqrt.comp:15-18)."""
    return np.sqrt(img_u16.astype(F)).astype(F)


def _reduce_chain(img: np.ndarray, mode: str, area: int = 8) -> float:
    """Iterated 8x8 block reduce until 1x1, reproducing two GPU artifacts:

    * the result of every step is stored through ``uvec4(value)``
      (shaders/img_max_reduce.comp:52, min_reduce.comp:30), truncating the
      float to an unsigned integer;
    * out-of-bounds ``imageLoad`` returns 0 (robust image access), so when a
      step's input size is not a multiple of 8 the min chain absorbs zeros
      (for 3072: 3072->384->48->6->1, the final step reads an 8x8 window from
      a 6x6 image -> global min is always 0).
    """
    cur = img.astype(F)
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        out_w = -(-cur.shape[0] // area)
        out_h = -(-cur.shape[1] // area)
        padded = np.zeros((out_w * area, out_h * area), dtype=F)
        padded[: cur.shape[0], : cur.shape[1]] = cur
        blocks = padded.reshape(out_w, area, out_h, area)
        if mode == "max":
            red = blocks.max(axis=(1, 3))
        else:
            red = blocks.min(axis=(1, 3))
        cur = np.trunc(red).astype(F)  # uvec4() cast: truncate toward zero
    return float(cur[0, 0])


def global_max(sqrt_img: np.ndarray, quirks: bool = True) -> float:
    if quirks:
        return _reduce_chain(sqrt_img, "max")
    return float(sqrt_img.max())


def global_min(sqrt_img: np.ndarray, quirks: bool = True) -> float:
    if quirks:
        return _reduce_chain(sqrt_img, "min")
    return float(sqrt_img.min())


def img_normalize(sqrt_img: np.ndarray, vmax: float, vmin: float,
                  quirks: bool = True) -> np.ndarray:
    """(x - min) / (max - min).  The reference's ``clamp`` result is discarded
    (shaders/img_normalize.comp:27), so quirks mode does NOT clamp."""
    out = ((sqrt_img - F(vmin)) / (F(vmax) - F(vmin))).astype(F)
    if not quirks:
        out = np.clip(out, 0.0, 1.0)
    return out


# ----------------------------------------------------------------------
# 5x5 Burt-Adelson smoothing
# ----------------------------------------------------------------------

def _smooth_weights() -> np.ndarray:
    a = F(0.3)
    return np.array([F(0.25) - a / 2, F(0.25), a, F(0.25), F(0.25) - a / 2], dtype=F)


def _mirror_index(n: int, lo: int, hi: int) -> int:
    """GLSL mirror() (shaders/img_smooth.comp:10-16).

    Single reflection pass; the trailing clamp's result is discarded, so for
    sizes <= 2 the reflected index can still be out of bounds -> the caller
    treats it as an OOB read returning 0.
    """
    v = n
    if v > hi:
        v = hi - (v - hi)
    elif v < lo:
        v = lo + (lo - v)
    return v


def _mirror_tap(img: np.ndarray, axis: int, offset: int) -> np.ndarray:
    """img shifted by `offset` along `axis` with mirror boundary (OOB -> 0)."""
    n = img.shape[axis]
    idx = np.empty(n, dtype=np.int64)
    valid = np.empty(n, dtype=bool)
    for i in range(n):
        j = _mirror_index(i + offset, 0, n - 1)
        ok = 0 <= j <= n - 1
        idx[i] = j if ok else 0
        valid[i] = ok
    taken = np.take(img, idx, axis=axis)
    mask_shape = [1, 1]
    mask_shape[axis] = n
    return taken * valid.reshape(mask_shape).astype(F)


def img_smooth(img: np.ndarray, gain: float = 1.0) -> np.ndarray:
    """Separable-weight 5x5 kernel, mirror boundary
    (shaders/img_smooth.comp:17-45); gain=4.0 gives img_smooth_upsampled
    (shaders/img_smooth_upsampled.comp:44).

    The GLSL accumulates ``weight[m]*weight[n]*pixel`` over the full 5x5
    window in one f32 sum; a separable two-pass implementation changes the
    accumulation order slightly (within f32 ulp), so the golden model does the
    full 2-D accumulation in float64 then rounds once, which all
    implementations must match to ~1e-6 relative.
    """
    w = _smooth_weights()
    acc = np.zeros(img.shape, dtype=np.float64)
    for m in range(5):
        tap_x = _mirror_tap(img, 0, m - 2)
        for n in range(5):
            tap = _mirror_tap(tap_x, 1, n - 2)
            acc += np.float64(w[m]) * np.float64(w[n]) * F(gain) * tap.astype(np.float64)
    return acc.astype(F)


def img_downsample(img: np.ndarray) -> np.ndarray:
    """Decimate by 2 (shaders/img_downsample.comp:15): out[x,y] = in[2x,2y]."""
    return img[::2, ::2].copy()


def img_upsample(img: np.ndarray, out_size: int) -> np.ndarray:
    """Zero-stuff x2 (shaders/img_upsample.comp:18): out[2x,2y] = in[x,y]."""
    out = np.zeros((out_size, out_size), dtype=F)
    out[::2, ::2] = img[: (out_size + 1) // 2, : (out_size + 1) // 2]
    return out


# ----------------------------------------------------------------------
# analysis phase
# ----------------------------------------------------------------------

def img_sdev(img: np.ndarray) -> np.ndarray:
    """5x5 RMS: sqrt(mean of x^2), zero padding at borders (OOB imageLoad -> 0)
    (shaders/img_sdev.comp:15-29).  Not mean-subtracted."""
    sq = (img.astype(F) ** 2).astype(F)
    padded = np.zeros((img.shape[0] + 4, img.shape[1] + 4), dtype=np.float64)
    padded[2:-2, 2:-2] = sq
    acc = np.zeros(img.shape, dtype=np.float64)
    for m in range(5):
        for n in range(5):
            acc += padded[m:m + img.shape[0], n:n + img.shape[1]]
    return np.sqrt(acc / 25.0).astype(F)


def noise_histogram(sdev: np.ndarray, cfg: MusicaConfig) -> np.ndarray:
    """Per-level noise histogram with the reference's early-`break` semantics
    (shaders/noise_hist.comp:21-47).

    Each GPU thread scans a 16x16 tile in column order (m = x offset outer,
    n = y offset inner).  On the FIRST pixel in a tile-column that is 0, out
    of range (> 0.1) or maps to bin 0, the scan of that tile-column stops
    (``break``) -- subsequent pixels in the same tile-column never count.
    Bin = int(v/0.1 * 2048 + 0.5); adds land in bins [1, 2047] (2048 is an
    OOB atomic, dropped).  Coverage is limited to cfg.hist_coverage pixels.
    """
    bins = cfg.noise_histogram_bins
    tile = cfg.histogram_area_size
    hist = np.zeros(bins, dtype=np.int64)
    cov = min(cfg.hist_coverage, -(-sdev.shape[0] // tile) * tile) if cfg.quirks \
        else -(-sdev.shape[0] // tile) * tile
    n_tiles = cov // tile if cfg.quirks else -(-sdev.shape[0] // tile)
    for tx in range(n_tiles):
        for ty in range(n_tiles):
            for m in range(tile):
                x = tx * tile + m
                for n in range(tile):
                    y = ty * tile + n
                    v = sdev[x, y] if (x < sdev.shape[0] and y < sdev.shape[1]) else F(0.0)
                    if v == 0.0:
                        break
                    adjusted = F(v / F(cfg.max_noise_value))
                    if adjusted > 1.0:
                        break
                    bin_pos = int(adjusted * F(bins) + F(0.5))
                    if bin_pos == 0:
                        break
                    if bin_pos < bins:
                        hist[bin_pos] += 1
    return hist


def histogram_max(hist: np.ndarray):
    """Single-thread argmax, strict > keeps the first max
    (shaders/img_histogram_max.comp:17-31).  Returns (max_value, max_bin)."""
    max_value = 0
    max_bin = 0
    for i, v in enumerate(hist):
        if v > max_value:
            max_value = int(v)
            max_bin = i
    return max_value, max_bin


# ----------------------------------------------------------------------
# curves (piecewise quadratic bezier -> point list; linear-search getY)
# ----------------------------------------------------------------------

def _bezier_points(start, middle, end, n_points: int, inclusive: bool):
    """Quadratic bezier sampled at t = i/10.

    contrast_curve_generate uses ``i <= 10`` (11 points,
    shaders/contrast_curve_generate.comp:40); gradation_curve_generate uses
    ``i < 10`` (10 points, endpoint excluded,
    shaders/gradation_curve_generate.comp:31).
    """
    pts = []
    last = n_points if inclusive else n_points - 1
    for i in range(last + 1):
        t = F(i) / F(n_points)
        xa = F(start[0] + (middle[0] - start[0]) * t)
        ya = F(start[1] + (middle[1] - start[1]) * t)
        xb = F(middle[0] + (end[0] - middle[0]) * t)
        yb = F(middle[1] + (end[1] - middle[1]) * t)
        x = F(xa + (xb - xa) * t)
        y = F(ya + (yb - ya) * t)
        pts.append((x, y))
    return pts


def contrast_curve_generate(max_bin: int, low_contrast_factor: float,
                            high_contrast_factor: float, cfg: MusicaConfig):
    """Per-level contrast LUT (shaders/contrast_curve_generate.comp:56-90).

    Coarse levels (lcf == 1): flat line at hcf.  Fine levels: 3 bezier
    segments around maxBinPosition = maxBin/2048 * 0.1.  Returns (px, py)
    float32 arrays.
    """
    lcf, hcf = F(low_contrast_factor), F(high_contrast_factor)
    pts = []
    if lcf == 1.0:
        pts = [(F(0.0), hcf), (F(1.0), hcf)]
    else:
        p = F(F(F(max_bin) * F(1.0 / cfg.noise_histogram_bins)) * F(cfg.max_noise_value))
        pts += _bezier_points((F(0.0), F(1.0)), (p * 4 / 5, lcf), (p, lcf), 10, True)
        pts += _bezier_points((p, lcf), (p * 6 / 5, lcf), (p * 7 / 5, lcf * 4 / 5), 10, True)
        pts += _bezier_points((p * 7 / 5, lcf * 4 / 5), (p * 2, F(1.0)), (F(1.0), F(1.0)), 10, True)
    px = np.array([p[0] for p in pts], dtype=F)
    py = np.array([p[1] for p in pts], dtype=F)
    return px, py


def curve_get_y(px: np.ndarray, py: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Vectorized transcription of the GLSL getY linear search
    (shaders/contrast_curve_apply.comp:27-36, img_apply_gradation_curve.comp).

    First-match over i of [exact: px[i] == x] then [segment: px[i] <= x <=
    px[i+1]]; the read of px[count] (one past the end) returns 0 (cleared
    buffer tail), so x beyond the last point falls through to 0.0.  The
    segment branch evaluates ``m * (x - px[i]) + py[i]`` (the shader passes
    ``x - points[i].x`` into linearFunction).
    """
    x = np.asarray(x, dtype=F)
    n = len(px)
    px_ext = np.concatenate([px, np.zeros(1, dtype=F)])
    py_ext = np.concatenate([py, np.zeros(1, dtype=F)])
    result = np.zeros(x.shape, dtype=F)
    found = np.zeros(x.shape, dtype=bool)
    for i in range(n):
        exact = (px_ext[i] == x) & ~found
        result = np.where(exact, py_ext[i], result)
        found |= exact
        seg = (px_ext[i] <= x) & (px_ext[i + 1] >= x) & ~found
        with np.errstate(divide="ignore", invalid="ignore"):
            m = F((py_ext[i + 1] - py_ext[i])) / F((px_ext[i + 1] - px_ext[i]))
        val = (m * (x - px_ext[i]) + py_ext[i]).astype(F)
        result = np.where(seg, val, result)
        found |= seg
    return result.astype(F)


def contrast_curve_apply(bandpass: np.ndarray, sdev: np.ndarray,
                         px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """out = bandpass * curveY(sdev) (shaders/contrast_curve_apply.comp:38-63)."""
    return (bandpass * curve_get_y(px, py, sdev)).astype(F)


# ----------------------------------------------------------------------
# CNR / noise reduction / relevance
# ----------------------------------------------------------------------

def img_cnr(sdev: np.ndarray, max_bin: int, cfg: MusicaConfig) -> np.ndarray:
    """cnr = sdev / referenceNoiseLevel, stored / 256
    (shaders/img_cnr.comp:23-44); reference level clipped to >= 1 bin."""
    # stepwise f32 rounding: (maxBin * (1/2048)) * 0.1
    ref = F(F(F(max_bin) * F(1.0 / cfg.noise_histogram_bins)) * F(cfg.max_noise_value))
    if ref == 0.0:
        ref = F(F(1.0 / cfg.noise_histogram_bins) * F(cfg.max_noise_value))
    return (sdev / ref / F(cfg.max_cnr_value)).astype(F)


def _nearest_upsample(small: np.ndarray, target: int) -> np.ndarray:
    """Integer-scale nearest upsample: scale = ceil(target/size), idx = x//scale
    (shaders/noise_reduction.comp:38-46, img_relevant.comp:32-39)."""
    scale = int(math.ceil(target / small.shape[0]))
    idx = np.arange(target) // scale
    idx = np.clip(idx, 0, small.shape[0] - 1)
    return small[np.ix_(idx, np.clip(np.arange(target) // scale, 0, small.shape[1] - 1))]


def noise_reduction(bandpass: np.ndarray, cnr: np.ndarray,
                    low_cnr: float, low_factor: float,
                    high_cnr: float, high_factor: float,
                    cfg: MusicaConfig) -> np.ndarray:
    """Per-pixel clamped linear ramp vs upsampled CNR
    (shaders/noise_reduction.comp:25-58)."""
    cnr_up = _nearest_upsample(cnr, bandpass.shape[0]) * F(cfg.max_cnr_value)
    m = F(high_factor - low_factor) / F(high_cnr - low_cnr)
    factor = np.where(
        cnr_up < low_cnr, F(low_factor),
        np.where(cnr_up > high_cnr, F(high_factor),
                 (m * cnr_up + F(low_factor)).astype(F)))
    # NOTE: the GLSL linearFunction evaluates m*x + p1.y with ABSOLUTE x here
    # (no x-offset subtraction, unlike the curve getY), i.e. the ramp is
    # anchored at x=0, not at lowCnr: factor(lowCnr) = m*lowCnr + lowFactor.
    return (bandpass * factor).astype(F)


def img_relevant(normalized: np.ndarray, cnr: np.ndarray, cfg: MusicaConfig) -> np.ndarray:
    """Relevance mask (shaders/img_relevant.comp:27-63)."""
    size = normalized.shape[0]
    cnr_up = _nearest_upsample(cnr, size) * F(cfg.max_cnr_value)
    xs = np.arange(size)
    border = cfg.relevant_border
    in_border = ((xs > border) & (xs < size - border))
    in_b2d = in_border[:, None] & in_border[None, :]
    lo = F(cfg.relevant_cnr_low)
    ramp_top = F(cfg.relevant_cnr_low + cfg.relevant_cnr_ramp)
    hi = F(cfg.max_cnr_value)
    ramp_region = (cnr_up >= lo) & (cnr_up <= ramp_top) & in_b2d
    solid_region = ((cnr_up >= ramp_top) & (cnr_up <= hi)
                    & (normalized <= F(cfg.relevant_max_pixel)) & in_b2d)
    base = (cnr_up / ramp_top).astype(F)
    if float(cfg.relevant_k).is_integer() and 1 <= int(cfg.relevant_k) <= 8:
        ramp_val = base
        for _ in range(int(cfg.relevant_k) - 1):
            ramp_val = (ramp_val * base).astype(F)
    else:
        ramp_val = (base ** F(cfg.relevant_k)).astype(F)
    out = np.zeros_like(normalized, dtype=F)
    out = np.where(ramp_region, ramp_val, out)
    out = np.where(~ramp_region & solid_region, F(1.0), out)
    return out.astype(F)


# ----------------------------------------------------------------------
# gradation
# ----------------------------------------------------------------------

def gradation_histogram(recon: np.ndarray, relevant: np.ndarray,
                        cfg: MusicaConfig) -> np.ndarray:
    """1024-bin histogram of the reconstructed image weighted by
    uint(relevant * 100) (shaders/gradation_histogram.comp:20-33).

    Quirk: ``return`` (not break) on the first pixel == 0.0 aborts the WHOLE
    16x16 tile scan (column-major: m outer over x, n inner over y).
    bin = int(pixel * 1024) truncated; bins >= 1024 are OOB atomics (dropped);
    negative pixels truncate toward zero into bin 0 (pixel in (-1,0)) or
    negative bins (dropped).
    """
    bins = cfg.grad_histogram_bins
    tile = cfg.histogram_area_size
    hist = np.zeros(bins, dtype=np.int64)
    n_tiles = -(-recon.shape[0] // tile)  # ceil dispatch (vk_processing.cpp:2492)
    for tx in range(n_tiles):
        for ty in range(n_tiles):
            aborted = False
            for m in range(tile):
                if aborted:
                    break
                x = tx * tile + m
                for n in range(tile):
                    y = ty * tile + n
                    v = recon[x, y] if (x < recon.shape[0] and y < recon.shape[1]) else F(0.0)
                    if v == 0.0:
                        aborted = True
                        break
                    bin_pos = int(v * bins)  # trunc toward zero
                    if 0 <= bin_pos < bins:
                        w = int(relevant[x, y] * 100) if (x < relevant.shape[0] and y < relevant.shape[1]) else 0
                        hist[bin_pos] += w
    return hist


def gradation_curve_generate(hist: np.ndarray, cfg: MusicaConfig):
    """Histogram-driven tone curve (shaders/gradation_curve_generate.comp:49-182).

    Returns (px, py, (t0, ta, t1)).  Quirks preserved: uint32 wrap-around of
    the weighted mean accumulator, integer division for the mean bin, strict->
    argmax only over bins [10, mean_bin), contiguous-run window searches.
    """
    bins = cfg.grad_histogram_bins
    lowest = cfg.grad_lowest_relevant_bin
    counts = (hist // 100).astype(np.uint64)

    # mean (uint32 arithmetic with wrap-around)
    mean_count = np.uint32(0)
    mean_sum = np.uint32(0)
    with np.errstate(over="ignore"):
        for i in range(lowest, bins):
            c = np.uint32(counts[i])
            mean_count = np.uint32(mean_count + c * np.uint32(i))
            mean_sum = np.uint32(mean_sum + c)
    if mean_sum == 0:
        mean_bin = 0  # GLSL uint div-by-zero is UB; pick 0 (empty image)
    else:
        mean_bin = int(mean_count // mean_sum)
    mean_hist_pos = F(F(mean_bin) / F(bins))

    # max over [lowest, mean_bin)
    max_count = 0
    max_position = 0
    for i in range(lowest, int(mean_hist_pos * F(bins))):
        if counts[i] > max_count:
            max_count = int(counts[i])
            max_position = i

    low_threshold = int(max_count * cfg.grad_low_threshold_frac)

    # t0: walk down from max while count >= lowThreshold
    t0 = F(0.0)
    i = max_position
    while i > 0:
        if counts[i] >= low_threshold:
            t0 = F(i * (1.0 / bins))
        else:
            break
        i -= 1

    # t1: walk up from max while count > 0
    t1 = F(0.0)
    i = max_position
    while i < bins:
        if counts[i] > 0:
            t1 = F(i * (1.0 / bins))
        else:
            break
        i += 1

    ta = F(max_position * (1.0 / bins))

    t0 = F(t0 - F(cfg.grad_t0_backoff))
    if t0 < 0.0:
        t0 = F(0.0)
    if t1 > 1.0:
        t1 = F(1.0)

    m = F(cfg.grad_slope)
    y_m = F(cfg.grad_y_mid)
    tf = F(-(F(0.5) / m) + ta)
    if tf < t0:
        tf = t0

    pts = [(F(0.0), F(0.0))]
    pts += _bezier_points((t0, F(0.0)), (tf, F(0.0)), (ta, y_m), 10, False)
    if tf == t0:
        m = F(y_m / (ta - tf)) if ta != tf else F(np.inf)
    ts = F((y_m / m) + ta)
    pts += _bezier_points((ta, y_m), (ts, F(1.0)), (t1, F(1.0)), 10, False)
    pts.append((F(1.0), F(1.0)))

    px = np.array([p[0] for p in pts], dtype=F)
    py = np.array([p[1] for p in pts], dtype=F)
    return px, py, (float(t0), float(ta), float(t1))


def apply_gradation_curve(recon: np.ndarray, px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """Final tone map (shaders/img_apply_gradation_curve.comp:38-45)."""
    return curve_get_y(px, py, recon)


# ----------------------------------------------------------------------
# CLAHE variant (ENABLE_CLAHE, include/vk_processing.h:13 -- compiled out
# by default; wiring at src/vk_processing.cpp:2470-2489: consumes the FINAL
# reconstruction expandImageStates[L-1] (:1903-1906) plus the relevance
# image, and writes its own claheGradedImageState (:1968-1973) -- it never
# feeds the normal gradation output, even under GRAD_WITH_LINEAR_IMAGE)
# ----------------------------------------------------------------------

def clahe_histograms(recon: np.ndarray, relevant: np.ndarray,
                     cfg: MusicaConfig) -> np.ndarray:
    """shaders/clahe_histogram.comp:13-45: per 4x4 tile, a 256-bin histogram
    of pixels with relevant == 1.0; bin = int(pixel * (bins-1) + 0.5)
    (truncation; OOB bins are dropped atomics); tile =
    uint(coord / imageSize * TILES_COUNT)."""
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    n = recon.shape[0]
    h = np.zeros((t, t, bins), np.int64)
    tile_of = [int(F(F(x) / F(n)) * F(t)) for x in range(n)]
    for x in range(n):
        tx = tile_of[x]
        for y in range(n):
            if relevant[x, y] == 1.0:
                b = int(F(recon[x, y]) * (bins - 1) + F(0.5))
                if 0 <= b < bins:
                    h[tx, tile_of[y], b] += 1
    return h


def clahe_curves(hists: np.ndarray, cfg: MusicaConfig):
    """shaders/clahe_grad_curve.comp:22-97: per tile, normalize by the tile's
    total count (0/0 -> nan like the GLSL), clip at 1/32 accumulating the
    excess in loop order, redistribute uniformly, then a SEQUENTIAL f32
    cumulative sum.  Returns (px[bins], py[t, t, bins]); the shared x grid is
    i/bins with the last point clamped to 1.0."""
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    px = (np.arange(bins, dtype=F) * F(1.0 / bins)).astype(F)
    px[bins - 1] = 1.0
    py = np.zeros((t, t, bins), F)
    clip = F(cfg.clahe_clip_limit)
    for i in range(t):
        for j in range(t):
            count = int(hists[i, j].sum())
            with np.errstate(divide="ignore", invalid="ignore"):
                y = (hists[i, j].astype(F) / F(count)).astype(F)
            clip_count = F(0.0)
            for k in range(bins):
                if y[k] > clip:
                    clip_count = F(clip_count + F(y[k] - clip))
                    y[k] = clip
            clip_add = F(clip_count / F(bins))
            y = (y + clip_add).astype(F)
            curr = F(0.0)
            for k in range(bins):
                curr = F(curr + y[k])
                py[i, j, k] = curr
    return px, py


def clahe_apply(recon: np.ndarray, px: np.ndarray, py: np.ndarray,
                cfg: MusicaConfig) -> np.ndarray:
    """shaders/clahe_grad_curve_apply.comp:38-160: bilinear blend of the
    getY values of up to 4 neighboring tile LUTs, weighted by
    (1 - |tileCenter - coord|) per axis, accumulated in the shader's
    tileCentPos order (base, +x, +y, +xy).

    UB note: at edge pixels ``uint(floor(baseTileCoord + sign(diff)))``
    converts a negative float to uint (undefined in GLSL); like
    ops/clahe.py we take the saturate-to-0 behavior, which makes the edge
    neighbor collapse onto the base tile.
    """
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    n = recon.shape[0]
    ts = n // t  # GRID_TILE_SIZE: integer division (:44)
    # evaluate every tile LUT over the image with the exact getY walk
    maps = np.empty((t, t) + recon.shape, F)
    for i in range(t):
        for j in range(t):
            maps[i, j] = curve_get_y(px, py[i, j], recon)

    coord = (np.arange(n, dtype=F) / F(ts)).astype(F)       # texel / tileSize
    base = (np.floor(coord).astype(F) + F(0.5)).astype(F)   # uint(c) + 0.5
    diff = (coord - base).astype(F)
    sgn = np.sign(diff).astype(np.int64)
    base_i = np.floor(base).astype(np.int64)
    nb_i = np.clip(base_i + sgn, 0, t - 1)                  # saturating uint
    base_i = np.clip(base_i, 0, t - 1)
    w_base = (F(1.0) - np.abs(base - coord)).astype(F)
    nb_center = ((base_i + sgn).astype(F) + F(0.5)).astype(F)
    w_nb = (F(1.0) - np.abs(nb_center - coord)).astype(F)
    zero = diff == 0.0

    out = np.empty_like(recon, dtype=F)
    cols = np.arange(n)
    for x in range(n):
        bb = maps[base_i[x]][base_i, x, cols]
        nb = maps[nb_i[x]][base_i, x, cols]
        bn = maps[base_i[x]][nb_i, x, cols]
        nn = maps[nb_i[x]][nb_i, x, cols]
        # shader accumulation order: bb, +x(nb), +y(bn), +xy(nn)
        v4 = ((w_base[x] * w_base * bb + w_nb[x] * w_base * nb)
              + w_base[x] * w_nb * bn) + w_nb[x] * w_nb * nn
        vx0 = w_base * bb + w_nb * bn          # diff.x == 0: blend along y
        vy0 = w_base[x] * bb + w_nb[x] * nb    # diff.y == 0: blend along x
        row = np.where(zero[x] & zero, bb,
                       np.where(zero[x], vx0, np.where(zero, vy0, v4)))
        out[x] = row.astype(F)
    return out


def clahe_grade(recon: np.ndarray, relevant: np.ndarray,
                cfg: MusicaConfig) -> np.ndarray:
    """Full CLAHE gradation chain (histograms -> clipped CDFs -> blended
    apply), the golden oracle for ops/clahe.py."""
    h = clahe_histograms(recon, relevant, cfg)
    px, py = clahe_curves(h, cfg)
    return clahe_apply(recon, px, py, cfg)


# ----------------------------------------------------------------------
# output
# ----------------------------------------------------------------------

def save_out_u8(graded: np.ndarray, margin: int) -> np.ndarray:
    """Margin crop + x255 truncating uint8 cast (src/vk_processing.cpp:2603-2645)."""
    c = graded[margin:graded.shape[0] - margin, margin:graded.shape[1] - margin]
    return np.clip(np.trunc(F(255.0) * c), 0, 255).astype(np.uint8)


# ----------------------------------------------------------------------
# full pipeline
# ----------------------------------------------------------------------

def process(img_u16: np.ndarray, cfg: MusicaConfig | None = None,
            return_intermediates: bool = False):
    """Golden full MUSICA pass: mirrors VulkanProcessing::execute
    (src/vk_processing.cpp:2104-2601).  Slow; for tests on small images."""
    cfg = cfg or MusicaConfig(image_size=img_u16.shape[0])
    assert img_u16.shape == (cfg.image_size, cfg.image_size)
    L = cfg.pyramid_levels
    inter = {}

    # normalize
    s = img_sqrt(img_u16)
    vmax = global_max(s, cfg.quirks)
    vmin = global_min(s, cfg.quirks)
    normalized = img_normalize(s, vmax, vmin, cfg.quirks)
    inter["normalized"] = normalized

    # pyramid reduce
    bandpass, downs = [], []
    cur = normalized
    for i in range(L):
        sm = img_smooth(cur)
        dn = img_downsample(sm)
        up = img_upsample(dn, cur.shape[0])
        low = img_smooth(up, gain=4.0)
        bandpass.append((cur - low).astype(F))
        downs.append(dn)
        cur = dn
    inter["bandpass"] = bandpass
    inter["downsampled"] = downs

    # analysis
    sdevs = {}
    max_bins = {}
    for i in cfg.analysis_levels:
        sd = img_sdev(bandpass[i])
        sdevs[i] = sd
        h = noise_histogram(sd, cfg)
        _, mb = histogram_max(h)
        max_bins[i] = mb
    inter["sdev"] = sdevs
    inter["noise_max_bins"] = max_bins

    curves = []
    for i in range(L):
        lcf, hcf = cfg.contrast_factors[i]
        curves.append(contrast_curve_generate(max_bins.get(i, 0), lcf, hcf, cfg))

    # apply
    cnr = img_cnr(sdevs[cfg.cnr_level], max_bins[cfg.cnr_level], cfg)
    inter["cnr"] = cnr
    exp_bandpass = []
    for i in range(L):
        px, py = curves[i]
        if i in sdevs:
            # real getY on the computed sdev (for i == cnr_level the curve is
            # flat but getY still returns 0 for sdev outside [0,1])
            eb = contrast_curve_apply(bandpass[i], sdevs[i], px, py)
        else:
            # sdev never computed for i > cnr_level in the reference (stale
            # image memory); the flat 2-point curve makes gain == hcf for any
            # sdev in [0,1], so apply the flat gain directly.
            eb = (bandpass[i] * F(cfg.contrast_factors[i][1])).astype(F)
        exp_bandpass.append(eb)
    inter["exp_bandpass"] = exp_bandpass

    nr_bandpass = {}
    for lvl in range(cfg.cnr_level):
        lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[lvl]
        nr_bandpass[lvl] = noise_reduction(exp_bandpass[lvl], cnr, lo_c, lo_f, hi_c, hi_f, cfg)
    inter["nr_bandpass"] = nr_bandpass

    # pyramid expand; levels < cnr_level-1 use the noise-reduced bandpass
    # (src/vk_processing.cpp:1043-1049: currentLevel < cnrLevel - 1)
    recon = downs[L - 1]
    for i in range(L):
        lvl = L - 1 - i
        up = img_upsample(recon, bandpass[lvl].shape[0])
        low = img_smooth(up, gain=4.0)
        band = nr_bandpass[lvl] if lvl < cfg.cnr_level - 1 else exp_bandpass[lvl]
        recon = (low + band).astype(F)
    inter["recon"] = recon

    # gradation (GRAD_WITH_LINEAR_IMAGE squares the reconstruction first,
    # shaders/img_linear.comp)
    grad_input = (recon * recon).astype(F) if cfg.grad_with_linear_image else recon
    relevant = img_relevant(normalized, cnr, cfg)
    inter["relevant"] = relevant
    if cfg.enable_clahe:
        # CLAHE grades the raw reconstruction (not grad_input), into its own
        # output image (src/vk_processing.cpp:1903-1906, 2470-2489)
        inter["clahe_graded"] = clahe_grade(recon, relevant, cfg)
    ghist = gradation_histogram(grad_input, relevant, cfg)
    inter["grad_hist"] = ghist
    gpx, gpy, tvals = gradation_curve_generate(ghist, cfg)
    inter["grad_curve"] = (gpx, gpy, tvals)
    graded = apply_gradation_curve(grad_input, gpx, gpy)
    inter["graded"] = graded

    out = save_out_u8(graded, cfg.out_margin)
    if return_intermediates:
        return out, inter
    return out
