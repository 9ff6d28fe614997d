"""Similarity metrics for the metamorphic campaign.

Transcribes ``test/metamorphic_test/script.py:143-198``:

* ``mse_similarity``  = 1 - RMSE/255 over uint8 images (:143-145);
* ``ssim_similarity`` -- scikit-image's default ``structural_similarity``
  re-implemented (7x7 uniform windows, K1=0.01, K2=0.03, data_range=255,
  sample covariance normalization), since skimage is not available here;
* ``hist_similarity`` -> (intersection, euclidean, bhattacharyya) over
  256-bin histograms; note the reference uses np.histogram's default
  *data-dependent* range per image -- preserved faithfully (:154-198).
"""

from __future__ import annotations

import math

import numpy as np


def _as_gray(img) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 3:
        # PIL 'L' conversion weights
        a = (a[..., 0] * 299 + a[..., 1] * 587 + a[..., 2] * 114) / 1000
    return a


def mse_similarity(image_a, image_b) -> float:
    a = np.asarray(image_a, dtype=np.int32)
    b = np.asarray(image_b, dtype=np.int32)
    errors = np.abs(a - b) / 255.0
    return 1.0 - math.sqrt(float(np.mean(np.square(errors))))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with 'reflect' boundary (scipy.ndimage.uniform_filter
    default mode), separable."""
    from scipy.ndimage import uniform_filter
    return uniform_filter(x, size=size, mode="reflect")


def ssim_similarity(image_a, image_b, win_size: int = 7,
                    data_range: float = 255.0, method: str = "auto") -> float:
    """Mean SSIM, matching skimage.metrics.structural_similarity defaults
    (uniform 7x7 window, crop pad, sample covariance with N/(N-1)).

    ``method``: 'numpy' (f64 host oracle), 'jax' (f32 on the default jax
    device, |delta| ~1e-6 vs the f64 oracle), or 'auto' (jax when an
    accelerator is the default backend)."""
    if method == "auto":
        import jax
        method = "jax" if jax.default_backend() not in ("cpu",) else "numpy"
    if method == "jax":
        import jax.numpy as jnp
        a = jnp.asarray(np.ascontiguousarray(_as_gray(image_a)))
        b = jnp.asarray(np.ascontiguousarray(_as_gray(image_b)))
        return float(_ssim_jax(a, b, win_size, float(data_range)))
    x = _as_gray(image_a).astype(np.float64)
    y = _as_gray(image_b).astype(np.float64)
    assert x.shape == y.shape
    k1, k2 = 0.01, 0.03
    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)
    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2
    return float(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad].mean())


def _make_ssim_jax():
    """Device SSIM (f32): same formula as the NumPy oracle with the uniform
    filter as reflect-pad + separable 7-tap box sums, jitted per shape
    (tests/test_metamorphic.py::test_ssim_jax_matches_numpy_oracle pins
    |jax - numpy| < 1e-5)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnames=("win_size", "data_range"))
    def ssim(a, b, win_size, data_range):
        x = a.astype(jnp.float32)
        y = b.astype(jnp.float32)
        w = win_size
        r = w // 2

        def box(m):
            p = jnp.pad(m, r, mode="reflect")
            h, wd = m.shape
            t = sum(p[i:i + h, :] for i in range(w))
            s = sum(t[:, j:j + wd] for j in range(w))
            return s * (1.0 / (w * w))

        k1, k2 = 0.01, 0.03
        cov_norm = (w * w) / (w * w - 1)
        ux, uy = box(x), box(y)
        uxx, uyy, uxy = box(x * x), box(y * y), box(x * y)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        c1 = (k1 * data_range) ** 2
        c2 = (k2 * data_range) ** 2
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
            (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
        return jnp.mean(s[r:s.shape[0] - r, r:s.shape[1] - r])

    return ssim


class _LazySsim:
    _fn = None

    def __call__(self, a, b, win_size, data_range):
        if _LazySsim._fn is None:
            _LazySsim._fn = _make_ssim_jax()
        return _LazySsim._fn(a, b, win_size, data_range)


_ssim_jax = _LazySsim()


def device_metrics_available() -> bool:
    """True when an accelerator is the default jax backend (the campaign
    then keeps the unaltered/reference images device-resident and computes
    each row's six similarity numbers in ONE jitted call)."""
    try:
        import jax
        return jax.default_backend() not in ("cpu",)
    except Exception:
        return False


def _ssim_mse_pair(jnp, af, bf):
    """f32 (mse-similarity, ssim) of one pair -- shared by the accelerator
    and CPU-backend measure programs (|delta| ~1e-6 vs the f64 oracles,
    pinned in tests/test_metamorphic.py)."""
    err = jnp.abs(af - bf) * jnp.float32(1.0 / 255.0)
    mse_sim = 1.0 - jnp.sqrt(jnp.mean(err * err))

    w, r = 7, 3

    def box(m):
        p = jnp.pad(m, r, mode="reflect")
        h, wd = m.shape
        t = sum(p[i:i + h, :] for i in range(w))
        s = sum(t[:, j:j + wd] for j in range(w))
        return s * (1.0 / (w * w))

    cov_norm = (w * w) / (w * w - 1)
    ux, uy = box(af), box(bf)
    uxx, uyy, uxy = box(af * af), box(bf * bf), box(af * bf)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    ssim = jnp.mean(s[r:s.shape[0] - r, r:s.shape[1] - r])
    return mse_sim, ssim


def _make_measure_row():
    """One fused device program per shape: mse + ssim of (alt vs unalt) and
    (alt vs ref) in f32, plus the EXACT 256-long per-value count vector of
    each u8 image (ops.stats.fixed_histogram).  The histogram metric
    itself is finished on the host from those counts in f64 (np.histogram
    over the weighted value axis), which is BIT-equal to the quirk-#26
    data-dependent-range oracle: np.histogram depends only on the value
    multiset, and a u8 image's multiset IS its bincount."""
    import jax
    import jax.numpy as jnp
    from ..ops.stats import fixed_histogram

    def counts256(img_u8):
        return fixed_histogram(img_u8.astype(jnp.int32),
                               jnp.ones(img_u8.shape, jnp.float32), 256)

    @jax.jit
    def measure(alt, unalt, ref):
        af = alt.astype(jnp.float32)
        m1 = _ssim_mse_pair(jnp, af, unalt.astype(jnp.float32))
        m2 = _ssim_mse_pair(jnp, af, ref.astype(jnp.float32))
        return (jnp.stack(m1 + m2),
                counts256(alt), counts256(unalt), counts256(ref))

    return measure


class _LazyMeasureRow:
    _fn = None

    def __call__(self, alt, unalt, ref):
        if _LazyMeasureRow._fn is None:
            _LazyMeasureRow._fn = _make_measure_row()
        return _LazyMeasureRow._fn(alt, unalt, ref)


_measure_row_jit = _LazyMeasureRow()


def _euclid_from_counts(ca: np.ndarray, cb: np.ndarray) -> float:
    """hist_similarity's normalized euclidean metric from exact per-value
    counts -- bit-equal to np.histogram on the images (quirk #26 range)."""
    def hist(c):
        nz = np.nonzero(c)[0]
        mn, mx = int(nz[0]), int(nz[-1])
        if mn == mx:
            # np.histogram auto-expands a constant image's range to
            # (v-0.5, v+0.5): all mass lands in bin 128
            h = np.zeros(256, np.float64)
            h[128] = c.sum()
            return h
        h, _ = np.histogram(np.arange(256, dtype=np.float64), bins=256,
                            range=(mn, mx), weights=c.astype(np.float64))
        return h
    pa = hist(ca)
    pb = hist(cb)
    pa = pa / pa.sum()
    pb = pb / pb.sum()
    return float(np.sqrt(np.sum((pa - pb) ** 2)) / np.sqrt(2))


def measure_row_device(alt, unalt_dev, ref_dev):
    """(mse, ssim, hist-euclid) of alt-vs-unalt and alt-vs-ref as 6 floats,
    with mse/ssim from one fused device call (only ``alt`` crosses the host
    boundary; keep ``unalt_dev``/``ref_dev`` device-resident) and the hist
    metric finished on host from exact device value counts."""
    import jax.numpy as jnp
    vals, ca, cu, cr = _measure_row_jit(
        jnp.asarray(np.ascontiguousarray(alt)), unalt_dev, ref_dev)
    vals = np.asarray(vals)
    ca, cu, cr = np.asarray(ca), np.asarray(cu), np.asarray(cr)
    return [float(vals[0]), float(vals[1]), _euclid_from_counts(ca, cu),
            float(vals[2]), float(vals[3]), _euclid_from_counts(ca, cr)]


def hist_similarity(image_a, image_b, bins: int = 256):
    """(normalized intersection, normalized euclidean distance,
    bhattacharyya coefficient); euclidean is the metric the campaign reports."""
    a = _as_gray(image_a).reshape(-1)
    b = _as_gray(image_b).reshape(-1)
    hist_a, _ = np.histogram(a, bins=bins)
    hist_b, _ = np.histogram(b, bins=bins)

    inter = float(np.sum(np.minimum(hist_a, hist_b))
                  / min(np.sum(hist_a), np.sum(hist_b)))

    pa = hist_a / np.sum(hist_a)
    pb = hist_b / np.sum(hist_b)
    e_distance = float(np.sqrt(np.sum((pa - pb) ** 2)) / np.sqrt(2))
    b_coeff = float(np.sum(np.sqrt(pa * pb)))
    return inter, e_distance, b_coeff


def psnr(a, b, peak: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(peak ** 2 / mse))
