"""CNR map, noise reduction, and relevance mask.

Design notes: the CNR image lives at the cnr_level resolution (384^2 for a
3072 input) and is consumed at finer resolutions through integer nearest
upsampling (scale = ceil(target/size), idx = x // scale --
shaders/noise_reduction.comp:38-46, img_relevant.comp:32-39); here that is
a repeat that XLA fuses into the consuming elementwise op.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from ..config import MusicaConfig

F32 = jnp.float32


def _pow_maybe_int(x, k: float):
    """x ** k; for small integer k an exact multiply chain, so every XLA
    backend and NumPy agree bit-for-bit (library pow differs by ulps
    across backends, which flips uint(rel*100) weight boundaries)."""
    if float(k).is_integer() and 1 <= int(k) <= 8:
        acc = x
        for _ in range(int(k) - 1):
            acc = acc * x
        return acc
    return x ** type(x.dtype.type(0))(k) if hasattr(x, "dtype") else x ** k


def img_cnr(sdev: jnp.ndarray, max_bin: jnp.ndarray, cfg: MusicaConfig) -> jnp.ndarray:
    """cnr = sdev / referenceNoiseLevel, stored / MAX_CNR
    (shaders/img_cnr.comp:23-44); reference noise clipped to >= 1 bin."""
    # stepwise f32 rounding as the GLSL evaluates it:
    # (maxBin * (1/2048)) * 0.1, each product rounded to f32
    inv_bins = F32(1.0 / cfg.noise_histogram_bins)
    mnv = F32(cfg.max_noise_value)
    ref = max_bin.astype(F32) * inv_bins * mnv
    ref = jnp.where(ref == 0.0, inv_bins * mnv, ref)
    return sdev / ref / F32(cfg.max_cnr_value)


def nearest_upsample(small: jnp.ndarray, target: int) -> jnp.ndarray:
    """Integer-scale nearest upsample: scale = ceil(target/size), idx = x//scale.

    jnp.repeat + slice (broadcast/reshape, which fuses into the consumer)
    instead of a gather; ``x // scale`` indexing is exactly
    ``repeat(scale)`` truncated to target.
    """
    size = small.shape[-1]
    scale = int(math.ceil(target / size))
    up = jnp.repeat(small, scale, axis=-2)[..., :target, :]
    return jnp.repeat(up, scale, axis=-1)[..., :, :target]


def noise_reduction(bandpass: jnp.ndarray, cnr: jnp.ndarray,
                    low_cnr: float, low_factor: float,
                    high_cnr: float, high_factor: float,
                    cfg: MusicaConfig) -> jnp.ndarray:
    """Per-pixel damping/boost from the CNR map (shaders/noise_reduction.comp:25-58).

    Quirk preserved: inside the ramp the GLSL linearFunction evaluates
    ``m * cnr + lowFactor`` with the ABSOLUTE cnr (no x-offset), i.e. the ramp
    is anchored at cnr = 0 and is discontinuous at both clamp edges:
    factor(lowCnr^-) = lowFactor but factor(lowCnr^+) = m*lowCnr + lowFactor.
    """
    cnr_up = nearest_upsample(cnr, bandpass.shape[-1]) * F32(cfg.max_cnr_value)
    m = F32((high_factor - low_factor) / (high_cnr - low_cnr))
    factor = jnp.where(
        cnr_up < low_cnr, F32(low_factor),
        jnp.where(cnr_up > high_cnr, F32(high_factor),
                  m * cnr_up + F32(low_factor)))
    return bandpass * factor


def img_relevant(normalized: jnp.ndarray, cnr: jnp.ndarray,
                 cfg: MusicaConfig) -> jnp.ndarray:
    """Relevance mask from CNR + intensity (shaders/img_relevant.comp:27-63):
    ramp (cnr/6)^5 for cnr in [1, 6]; 1.0 for cnr in [6, 256] and pixel
    <= 0.90; 100-px border excluded; else 0."""
    size = normalized.shape[-1]
    cnr_up = nearest_upsample(cnr, size) * F32(cfg.max_cnr_value)
    xs = jnp.arange(size)
    b = cfg.relevant_border
    inb = (xs > b) & (xs < size - b)
    inb2d = inb[:, None] & inb[None, :]
    lo = F32(cfg.relevant_cnr_low)
    top = F32(cfg.relevant_cnr_low + cfg.relevant_cnr_ramp)
    hi = F32(cfg.max_cnr_value)
    ramp_region = (cnr_up >= lo) & (cnr_up <= top) & inb2d
    solid_region = ((cnr_up >= top) & (cnr_up <= hi)
                    & (normalized <= F32(cfg.relevant_max_pixel)) & inb2d)
    ramp_val = _pow_maybe_int(cnr_up / top, cfg.relevant_k)
    out = jnp.where(ramp_region, ramp_val,
                    jnp.where(solid_region, F32(1.0), F32(0.0)))
    return out
