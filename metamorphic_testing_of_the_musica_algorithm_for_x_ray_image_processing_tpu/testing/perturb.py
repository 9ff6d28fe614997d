"""Metamorphic input perturbations (the MRs).

Transcribes ``test/metamorphic_test/script.py:49-141``; all functions take
and return uint16 [n, n] arrays (the file-layout orientation, i.e. what
``save_raw`` writes).

Families and intensity schedules (script.py:383-657):
  * quantum (Poisson) noise, dose factors {0.1, 0.05, 0.025, 0.0125, 0.00625}
  * gaussian noise, sigma in {4, 16, 64, 256, 1024}
  * collimator shutters 200..1000 step 200 (outside = dose/100 + Poisson)
  * translation x/y 300..1500 step 300, 99th-percentile fill
  * rotation 9..45 deg step 9, 95th-percentile fill
"""

from __future__ import annotations

import math

import numpy as np

QUANTUM_FACTORS = (0.1, 0.05, 0.025, 0.0125, 0.00625)
GAUSSIAN_SIGMAS = (4.0, 16.0, 64.0, 256.0, 1024.0)
COLLIMATOR_SHUTTERS = (200, 400, 600, 800, 1000)
TRANSLATIONS = (300, 600, 900, 1200, 1500)
ROTATIONS = (9, 18, 27, 36, 45)


def _scaled(vals, size: int, base: int = 3072):
    """Scale pixel-count schedules for smaller-than-reference images."""
    if size == base:
        return tuple(vals)
    return tuple(max(1, int(round(v * size / base))) for v in vals)


def apply_quantum_noise(img: np.ndarray, scale_factor: float = 1.0,
                        rng=None) -> np.ndarray:
    """Poisson noise at a dose scale (script.py:49-58)."""
    rng = rng or np.random.default_rng(0)
    scaled = img.astype(np.float64) * scale_factor
    noisy = rng.poisson(scaled).astype(np.float32) / scale_factor
    return np.clip(noisy, 0, np.iinfo(np.uint16).max).astype(np.uint16)


def add_gaussian_noise(img: np.ndarray, mean: float, sigma: float,
                       rng=None) -> np.ndarray:
    """Additive gaussian noise (script.py:60-66)."""
    rng = rng or np.random.default_rng(0)
    noise = rng.normal(mean, sigma, img.shape).astype(np.int32)
    return np.clip(img.astype(np.int32) + noise, 0, 65535).astype(np.uint16)


def apply_collimator(img: np.ndarray, shutter_h: int, shutter_v: int,
                     rng=None) -> np.ndarray:
    """Simulated collimation (script.py:75-95): outside the shutter window the
    dose drops to 1/100 with Poisson statistics."""
    rng = rng or np.random.default_rng(0)
    low = apply_quantum_noise((img / 100.0).astype(np.uint16), 1.0, rng)
    out = low.copy()
    out[shutter_v:img.shape[0] - shutter_v,
        shutter_h:img.shape[1] - shutter_h] = \
        img[shutter_v:img.shape[0] - shutter_v,
            shutter_h:img.shape[1] - shutter_h]
    return out


def clamp_translation(img: np.ndarray, x_shift: int = 0, y_shift: int = 0) -> np.ndarray:
    """Translate with 99th-percentile fill (script.py:97-120).

    The reference crops a `margin`-trimmed copy, estimates the fill from a
    small bright corner patch, then pastes at the shift offset.
    """
    margin = 10
    bright = 2
    h, w = img.shape
    left = margin if x_shift > 0 else 0
    right = w - margin if x_shift < 0 else w
    top = margin if y_shift > 0 else 0
    bottom = h - margin if y_shift < 0 else h
    cropped = img[top:bottom, left:right]

    b_right = margin + bright if x_shift > 0 else w
    b_bottom = margin + bright if y_shift > 0 else h
    patch = img[top:b_bottom, left:b_right]
    fill = int(np.percentile(patch, 99))

    out = np.full_like(img, fill)
    y0, x0 = y_shift, x_shift
    ys = slice(max(0, y0), min(h, y0 + cropped.shape[0]))
    xs = slice(max(0, x0), min(w, x0 + cropped.shape[1]))
    out[ys, xs] = cropped[: ys.stop - ys.start, : xs.stop - xs.start]
    return out


def _rotate_matrix(w: int, h: int, degree: float):
    """The inverse affine map (output -> input pixel) of PIL's
    ``Image.rotate(degree)`` about the image center, rounded as PIL rounds
    it (``Image.rotate``: cos/sin rounded to 15 digits)."""
    angle = -math.radians(degree % 360.0)
    a, b = round(math.cos(angle), 15), round(math.sin(angle), 15)
    d, e = round(-math.sin(angle), 15), round(math.cos(angle), 15)
    cx, cy = w / 2, h / 2
    return a, b, a * -cx + b * -cy + 0.0 + cx, d, e, d * -cx + e * -cy + 0.0 + cy


def rotate_nearest(img: np.ndarray, degree: float, fill: int = 0) -> np.ndarray:
    """NumPy port of PIL's ``Image.fromarray(img).rotate(degree,
    fillcolor=fill)`` (NEAREST resampling, no expand), bit-exact for uint8
    ("L") and uint16 ("I;16") images at the angles PIL rotates through its
    affine path (PIL transposes multiples of 90 degrees instead); pinned
    against PIL in tests/test_metamorphic.py.

    PIL samples the two modes differently (libImaging/Geometry.c): "L"
    takes the 16.16 fixed-point walk (``affine_fixed``), "I;16" the
    double-precision generic transform at pixel centers
    (``affine_transform`` + ``nearest_filter16``)."""
    h, w = img.shape
    a0, a1, a2, a3, a4, a5 = _rotate_matrix(w, h, degree)
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    if img.dtype == np.uint8:
        def fix(v):
            return math.floor(v * 65536.0 + 0.5)
        corners = [(0, 0), (w, h), (0, h), (w, 0)]
        if any(abs(cx * a0 + cy * a1 + a2) >= 32768.0
               or abs(cx * a3 + cy * a4 + a5) >= 32768.0
               for cx, cy in corners):
            raise ValueError("image too large for PIL's fixed-point rotate")
        xin = (fix(a2 + a1 * 0.5 + a0 * 0.5) + y * fix(a1) + x * fix(a0)) >> 16
        yin = (fix(a5 + a4 * 0.5 + a3 * 0.5) + y * fix(a4) + x * fix(a3)) >> 16
    elif img.dtype == np.uint16:
        xf, yf = x + 0.5, y + 0.5
        xs = a0 * xf + a1 * yf + a2
        ys = a3 * xf + a4 * yf + a5
        xin = np.where(xs < 0.0, -1, xs.astype(np.int64))
        yin = np.where(ys < 0.0, -1, ys.astype(np.int64))
    else:
        raise TypeError(f"rotate_nearest: uint8 or uint16, not {img.dtype}")
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.full_like(img, fill)
    out[ok] = img[yin[ok], xin[ok]]
    return out


def clamp_rotate(img: np.ndarray, degree: float) -> np.ndarray:
    """Rotate with 95th-percentile fill after 100-px margin crop
    (script.py:122-141), with PIL's NEAREST rotate as the harness used it
    (``rotate_nearest``).

    The reference's margin is a fixed 100 px (it only ever saw 3072² inputs);
    on tiny campaign sizes that would empty the crop, so it is clamped to
    keep at least a 2x2 interior — sizes >= 202 behave exactly as the
    reference."""
    margin = min(100, (min(img.shape) - 2) // 2)
    cropped = img[margin:img.shape[0] - margin, margin:img.shape[1] - margin]
    fill = int(np.percentile(cropped, 95))
    rot = rotate_nearest(cropped, degree, fill)
    out = np.full_like(img, fill)
    out[margin:margin + rot.shape[0], margin:margin + rot.shape[1]] = rot
    return out


def inner_rect_after_rotation(w: int, h: int, degree: float):
    """Largest axis-aligned inner rectangle after rotation, as computed by the
    harness for registration-normalized comparison (script.py:583-599)."""
    rad = math.radians(degree)
    new_w = w * abs(math.cos(rad)) + h * abs(math.sin(rad))
    new_h = h * abs(math.cos(rad)) + w * abs(math.sin(rad))
    inner_w = w * h / new_h if w < h else h * w / new_w
    inner_h = h * w / new_w if w < h else w * h / new_h
    left = (w - inner_w) / 2
    top = (h - inner_h) / 2
    return int(left), int(top), int((w + inner_w) / 2), int((h + inner_h) / 2)
