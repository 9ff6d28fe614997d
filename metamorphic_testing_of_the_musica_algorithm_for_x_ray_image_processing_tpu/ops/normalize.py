"""Input normalization: sqrt transform + global max/min + rescale.

The reference's 8x8 max/min reduce ladders (shaders/img_max_reduce.comp,
min_reduce.comp; chain wiring src/vk_processing.cpp:2189-2211) are an
artifact of the reference's shaders -- here a global reduce is one XLA
reduction.  In quirks mode we
still reproduce their two numerical artifacts exactly:

* every reduce step stores through ``uvec4(value)`` -- a float -> uint
  truncation (shaders/img_max_reduce.comp:52);
* out-of-bounds ``imageLoad`` returns 0, and the ceil(n/8) chain misaligns
  for most sizes (3072 -> 384 -> 48 -> 6 -> 1 reads an 8x8 window from a 6x6
  image), so the min chain absorbs zeros: the effective global min is 0.

Rather than hand-deriving the cases, quirks mode simply evaluates the chain
(a handful of tiny reshapes; the first step fuses with the sqrt).
"""

from __future__ import annotations

import jax.numpy as jnp


def img_sqrt(img_u16: jnp.ndarray) -> jnp.ndarray:
    """Variance-stabilizing sqrt (shaders/img_sqrt.comp:15-18)."""
    return jnp.sqrt(img_u16.astype(jnp.float32))


def _chain_misaligned(n: int, area: int = 8) -> bool:
    """True when some step of the ceil(n/8) reduce chain reads out of bounds
    (the min chain then absorbs zeros).  3072 -> 384 -> 48 -> 6(!) -> 1."""
    while n > 1:
        if n % area != 0:
            return True
        n = -(-n // area)
    return False


def global_max(sqrt_img: jnp.ndarray, quirks: bool = True) -> jnp.ndarray:
    """Chain semantics collapse to one reduction: trunc() is monotone, so the
    per-step uvec4 truncations equal a single trunc of the global max, and
    the OOB zero padding never raises a max of nonnegative values."""
    m = sqrt_img.max(axis=(-2, -1))
    return jnp.trunc(m) if quirks else m


def global_min(sqrt_img: jnp.ndarray, quirks: bool = True) -> jnp.ndarray:
    """Same collapse for min, except a misaligned chain pins the result to 0
    (decided statically from the image size)."""
    if not quirks:
        return sqrt_img.min(axis=(-2, -1))
    if _chain_misaligned(sqrt_img.shape[-1]) or _chain_misaligned(sqrt_img.shape[-2]):
        return jnp.zeros(sqrt_img.shape[:-2], sqrt_img.dtype)
    return jnp.trunc(sqrt_img.min(axis=(-2, -1)))


def normalize_from_u16(img_u16: jnp.ndarray, quirks: bool = True):
    """Fused fast path: (normalized, vmax, vmin) straight from the uint16
    input.  Bit-exact to sqrt -> global_max/min -> img_normalize: sqrt is
    monotone nondecreasing, so max/min commute with it (trunc(max(sqrt(x)))
    == trunc(sqrt(max(x))), same f32 values), letting the reductions run on
    the 2-byte input and the sqrt fuse into the normalize elementwise
    pass."""
    imax = img_u16.max(axis=(-2, -1)).astype(jnp.float32)
    imin = img_u16.min(axis=(-2, -1)).astype(jnp.float32)
    vmax = jnp.sqrt(imax)
    vmin = jnp.sqrt(imin)
    if quirks:
        vmax = jnp.trunc(vmax)
        if (_chain_misaligned(img_u16.shape[-1])
                or _chain_misaligned(img_u16.shape[-2])):
            vmin = jnp.zeros_like(vmin)
        else:
            vmin = jnp.trunc(vmin)
    s = img_sqrt(img_u16)
    return img_normalize(s, vmax, vmin, quirks), vmax, vmin


def img_normalize(sqrt_img: jnp.ndarray, vmax: jnp.ndarray, vmin: jnp.ndarray,
                  quirks: bool = True) -> jnp.ndarray:
    """(x - min) / (max - min); the reference's clamp is a discarded no-op
    (shaders/img_normalize.comp:27), so quirks mode does not clamp."""
    vmax = jnp.asarray(vmax, jnp.float32)[..., None, None]
    vmin = jnp.asarray(vmin, jnp.float32)[..., None, None]
    out = (sqrt_img - vmin) / (vmax - vmin)
    if not quirks:
        out = jnp.clip(out, 0.0, 1.0)
    return out
