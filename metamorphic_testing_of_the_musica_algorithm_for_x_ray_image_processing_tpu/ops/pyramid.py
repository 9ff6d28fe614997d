"""Gaussian/Laplacian pyramid ops: 5x5 Burt-Adelson smoothing (a = 0.3),
decimation, zero-stuff upsampling.

Design notes
------------
The reference runs four Vulkan dispatches per level (smooth, downsample,
upsample, smooth x4; ``src/vk_processing.cpp:2232-2273``).  Here each is a
pure function of static shape; XLA fuses the 5-tap separable convolutions
into single elementwise passes, and ``smooth_downsample`` computes only the kept
(even) output pixels -- the reference's full-resolution smooth image is never
consumed anywhere else (its only reader is the decimator), so fusing is
exact.

Boundary handling matches the GLSL ``mirror()`` (shaders/img_smooth.comp:10-16):
single reflection without edge repeat (``jnp.pad mode='reflect'``); for axes
of size <= 2 the reflected index can remain out of bounds, in which case the
Vulkan ``imageLoad`` returns 0 -- reproduced via masked gather.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def smooth_weights(dtype=jnp.float32):
    a = 0.3
    w = np.array([0.25 - a / 2, 0.25, a, 0.25, 0.25 - a / 2], dtype=np.float32)
    return w.astype(dtype)


def _mirror_idx(n: int):
    """Static tap indices/validity for positions -2..n+1 (GLSL mirror())."""
    idx = np.empty(n + 4, dtype=np.int32)
    valid = np.empty(n + 4, dtype=np.float32)
    for k in range(-2, n + 2):
        v = k
        if v > n - 1:
            v = (n - 1) - (v - (n - 1))
        elif v < 0:
            v = -v
        ok = 0 <= v <= n - 1
        idx[k + 2] = v if ok else 0
        valid[k + 2] = 1.0 if ok else 0.0
    return idx, valid


def mirror_pad(img: jnp.ndarray) -> jnp.ndarray:
    """Pad both spatial axes by 2 with mirror boundary (OOB -> 0)."""
    h, w = img.shape[-2], img.shape[-1]
    if h >= 3 and w >= 3:
        pad = [(0, 0)] * (img.ndim - 2) + [(2, 2), (2, 2)]
        return jnp.pad(img, pad, mode="reflect")
    out = img
    for axis, n in ((-2, h), (-1, w)):
        idx, valid = _mirror_idx(n)
        out = jnp.take(out, jnp.asarray(idx), axis=axis)
        shape = [1] * out.ndim
        shape[axis] = n + 4
        out = out * jnp.asarray(valid).reshape(shape)
    return out


def smooth(img: jnp.ndarray, gain: float = 1.0) -> jnp.ndarray:
    """Separable 5x5 smooth, mirror boundary (shaders/img_smooth.comp:17-45).

    gain=4.0 reproduces img_smooth_upsampled (the zero-stuffing energy
    compensation, shaders/img_smooth_upsampled.comp:44).
    """
    h, w = img.shape[-2], img.shape[-1]
    wts = smooth_weights(img.dtype)
    p = mirror_pad(img)
    tmp = sum(wts[m] * p[..., m:m + h, :] for m in range(5))
    out = sum(wts[n] * tmp[..., :, n:n + w] for n in range(5))
    if gain != 1.0:
        out = out * jnp.asarray(gain, img.dtype)
    return out


def downsample(img: jnp.ndarray) -> jnp.ndarray:
    """out[x, y] = in[2x, 2y] (shaders/img_downsample.comp:15)."""
    return img[..., ::2, ::2]


def smooth_downsample(img: jnp.ndarray) -> jnp.ndarray:
    """Fused smooth -> decimate: computes the 5x5 smooth only at even
    coordinates.  Bit-identical to ``downsample(smooth(img))`` because the
    intermediate smooth image has no other consumer in the pipeline.

    Interior outputs read the source directly (no mirror-padded copy in
    HBM); only the first/last output row/column touch the boundary and are
    evaluated via the static mirror index map.
    """
    h, w = img.shape[-2], img.shape[-1]
    dh, dw = -(-h // 2), -(-w // 2)
    wts = smooth_weights(img.dtype)
    if h < 8 or w < 8:
        p = mirror_pad(img)
        tmp = sum(wts[m] * p[..., m:m + 2 * dh - 1:2, :] for m in range(5))
        return sum(wts[n] * tmp[..., :, n:n + 2 * dw - 1:2] for n in range(5))

    def decimate_axis(a, axis, n, dn):
        idx, valid = _mirror_idx(n)  # taps for positions -2..n+1

        def tap_rows(positions):
            """Sum_m w_m * a[mirror(positions[m])] (single rows, static)."""
            total = None
            for m, pos in enumerate(positions):
                row = jnp.take(a, jnp.asarray([idx[pos + 2]]), axis=axis)
                row = row * (wts[m] * jnp.asarray(valid[pos + 2], a.dtype))
                total = row if total is None else total + row
            return total

        sl = [slice(None)] * a.ndim
        first = tap_rows([-2, -1, 0, 1, 2])
        last = tap_rows([2 * (dn - 1) + m - 2 for m in range(5)])
        interior = None
        for m in range(5):
            s = list(sl)
            s[axis] = slice(m, m + 2 * (dn - 2) - 1, 2)
            term = wts[m] * a[tuple(s)]
            interior = term if interior is None else interior + term
        return jnp.concatenate([first, interior, last], axis=axis)

    tmp = decimate_axis(img, img.ndim - 2, h, dh)
    return decimate_axis(tmp, img.ndim - 1, w, dw)


def split_planes(img: jnp.ndarray):
    """(h, w) -> 4 parity planes (ee, eo, oe, oo); first letter = row parity.

    One strided relayout here replaces the stride-2 tap reads that every
    level of the reduce ladder otherwise performs (5 strided slices per
    separable pass; the planes make every downstream stencil read
    unit-stride).

    Implementation note: the split is one-axis-at-a-time, so XLA fuses the
    two single-axis strided copies (a fused double-strided slice
    ``x[0::2, 0::2]`` was far slower on an earlier platform; not yet
    re-measured on the GPU).
    """
    a, b = img[..., 0::2, :], img[..., 1::2, :]
    return (a[..., :, 0::2], a[..., :, 1::2],
            b[..., :, 0::2], b[..., :, 1::2])


def interleave_planes(ee, eo, oe, oo) -> jnp.ndarray:
    """Inverse of split_planes for even sizes (stack+reshape, no scatter)."""
    def ileave(a, b, axis):
        st = jnp.stack([a, b], axis=a.ndim + axis + 1)
        shape = list(a.shape)
        shape[a.ndim + axis] *= 2
        return st.reshape(shape)

    top = ileave(ee, eo, -1)     # even rows
    bot = ileave(oe, oo, -1)     # odd rows
    return ileave(top, bot, -2)


def _rows_pass_split(pe, po, dh):
    """Row-decimating 5-tap pass on a (even-rows, odd-rows) plane pair.

    Output row j = sum_m w_m * cur[2j + m - 2] in m order (bit-identical to
    ``smooth_downsample``'s decimate over rows): taps hit planes
    pe[j-1], po[j-1], pe[j], po[j], pe[j+1]; borders mirror exactly as
    ``_mirror_idx`` resolves them (rows 2 -> pe[1], 1 -> po[0] at the top;
    the h tap mirrors back to pe[dh-1] at the bottom).  Requires dh >= 3.
    """
    w = smooth_weights(pe.dtype)
    first = (w[0] * pe[..., 1:2, :] + w[1] * po[..., 0:1, :]
             + w[2] * pe[..., 0:1, :] + w[3] * po[..., 0:1, :]
             + w[4] * pe[..., 1:2, :])
    interior = (w[0] * pe[..., 0:dh - 2, :] + w[1] * po[..., 0:dh - 2, :]
                + w[2] * pe[..., 1:dh - 1, :] + w[3] * po[..., 1:dh - 1, :]
                + w[4] * pe[..., 2:dh, :])
    last = (w[0] * pe[..., dh - 2:dh - 1, :] + w[1] * po[..., dh - 2:dh - 1, :]
            + w[2] * pe[..., dh - 1:dh, :] + w[3] * po[..., dh - 1:dh, :]
            + w[4] * pe[..., dh - 1:dh, :])
    return jnp.concatenate([first, interior, last], axis=-2)


def _cols_pass_split(te, to, dw):
    """Column-decimating 5-tap pass on (even-cols, odd-cols) planes; the
    transpose-free mirror of ``_rows_pass_split``."""
    w = smooth_weights(te.dtype)
    first = (w[0] * te[..., :, 1:2] + w[1] * to[..., :, 0:1]
             + w[2] * te[..., :, 0:1] + w[3] * to[..., :, 0:1]
             + w[4] * te[..., :, 1:2])
    interior = (w[0] * te[..., :, 0:dw - 2] + w[1] * to[..., :, 0:dw - 2]
                + w[2] * te[..., :, 1:dw - 1] + w[3] * to[..., :, 1:dw - 1]
                + w[4] * te[..., :, 2:dw])
    last = (w[0] * te[..., :, dw - 2:dw - 1] + w[1] * to[..., :, dw - 2:dw - 1]
            + w[2] * te[..., :, dw - 1:dw] + w[3] * to[..., :, dw - 1:dw]
            + w[4] * te[..., :, dw - 1:dw])
    return jnp.concatenate([first, interior, last], axis=-1)


def smooth_downsample_split(planes):
    """smooth_downsample on parity planes: bit-identical to
    ``smooth_downsample(interleave_planes(*planes))`` for even sizes >= 8.

    Row pass on each column-parity pair, then one unit-stride column pass;
    every tap has the same value and the same left-associated summation
    order as the strided-slice path.
    """
    ee, eo, oe, oo = planes
    dh, dw = ee.shape[-2], ee.shape[-1]
    te = _rows_pass_split(ee, oe, dh)   # even columns of tmp
    to = _rows_pass_split(eo, oo, dh)   # odd columns of tmp
    return _cols_pass_split(te, to, dw)


def reduce_step_split(planes):
    """One pyramid-reduce level on parity planes.

    Returns (bandpass_planes, dn): ``dn = smooth_downsample(cur)`` and
    ``bandpass = cur - upsample_smooth(dn, n)`` with the low image's four
    polyphase outputs kept as planes (they are exactly the a_qs arrays the
    polyphase ``upsample_smooth`` interleaves; the x4 gain and the
    subtraction commute elementwise with interleaving, so
    ``interleave_planes(*bandpass_planes)`` is bit-identical to the
    unsplit path).  Sizes must be even and >= 8.
    """
    ee, eo, oe, oo = planes
    dn = smooth_downsample_split(planes)
    n = 2 * ee.shape[-1]
    src = n // 2
    wts = smooth_weights(ee.dtype)
    we = (wts[0], wts[2], wts[4])
    wo = (wts[1], wts[3])
    edge = n - 1 - src

    def ext(a, axis):
        lo = jnp.take(a, jnp.asarray([1]), axis=axis)
        hi = jnp.take(a, jnp.asarray([edge]), axis=axis)
        return jnp.concatenate([lo, a, hi], axis=axis)

    def phase_conv(a, axis):
        e = ext(a, axis)
        sl = [slice(None)] * a.ndim

        def take(start, count):
            s = list(sl)
            s[axis] = slice(start, start + count)
            return e[tuple(s)]

        ph0 = (we[0] * take(0, src) + we[1] * take(1, src)
               + we[2] * take(2, src))
        ph1 = wo[0] * take(1, src) + wo[1] * take(2, src)
        return ph0, ph1

    r0, r1 = phase_conv(dn, dn.ndim - 2)
    a00, a01 = phase_conv(r0, dn.ndim - 1)
    a10, a11 = phase_conv(r1, dn.ndim - 1)
    gain = jnp.asarray(4.0, ee.dtype)
    band_planes = (ee - a00 * gain, eo - a01 * gain,
                   oe - a10 * gain, oo - a11 * gain)
    return band_planes, dn


def reduce_ladder(normalized: jnp.ndarray, levels: int):
    """The full pyramid-reduce ladder: (bandpass list, downs list).

    Uses the parity-plane path (``reduce_step_split``) while level sizes are
    even and >= 8, then the plain strided path for the small/odd tail --
    bit-identical to running ``smooth_downsample`` + ``upsample_smooth`` per
    level, with unit-stride stencil reads.
    """
    bandpass, downs = [], []
    h, w = normalized.shape[-2], normalized.shape[-1]
    cur = normalized
    planes = None
    for _ in range(levels):
        if h == w and h % 2 == 0 and h >= 8:
            if planes is None:
                planes = split_planes(cur)
            bp, dn = reduce_step_split(planes)
            bandpass.append(interleave_planes(*bp))
            downs.append(dn)
            planes = None
            cur = dn
        else:
            dn = smooth_downsample(cur)
            bandpass.append(cur - upsample_smooth(dn, cur.shape[-1]))
            downs.append(dn)
            cur = dn
            planes = None
        h, w = -(-h // 2), -(-w // 2)
    return bandpass, downs


def upsample(img: jnp.ndarray, out_size: int) -> jnp.ndarray:
    """Zero-stuff x2: out[2x, 2y] = in[x, y] (shaders/img_upsample.comp:18).

    Implemented as stack + reshape interleaving rather than a strided
    scatter (``.at[::2, ::2].set``), which XLA does not fuse.
    """
    src = -(-out_size // 2)
    a = img[..., :src, :src]
    z = jnp.zeros_like(a)
    cols = jnp.stack([a, z], axis=-1)
    cols = cols.reshape(cols.shape[:-3] + (src, 2 * src))[..., :, :out_size]
    zr = jnp.zeros_like(cols)
    rows = jnp.stack([cols, zr], axis=-2)
    rows = rows.reshape(rows.shape[:-3] + (2 * src, out_size))
    return rows[..., :out_size, :]


def upsample_smooth(img: jnp.ndarray, out_size: int) -> jnp.ndarray:
    """Zero-stuff then smooth with x4 gain = the pyramid 'lowpass'/expand step
    (shaders/img_upsample.comp + img_smooth_upsampled.comp).

    Computed in POLYPHASE form: three of every five taps of the separable
    smooth land on stuffed zeros, so each output phase (even/odd per axis)
    is a 3- or 2-tap convolution directly on the small image.  This is
    bit-exact to smooth(upsample(...)): the skipped terms are exact
    ``w * 0.0`` products and ``x + 0.0`` additions, and the GLSL mirror()
    preserves index parity (mirror(-t) = t, mirror(2(n-1)-t) flips around an
    even pivot), so each phase's boundary extension maps back onto the small
    grid.  ~2x less HBM traffic than materializing the stuffed grid.
    """
    n = out_size
    src = -(-n // 2)
    if n < 6 or img.shape[-1] < 3 or img.shape[-2] < 3:
        return smooth(upsample(img, out_size), gain=4.0)
    r = img[..., :src, :src]
    wts = smooth_weights(img.dtype)
    we = (wts[0], wts[2], wts[4])  # taps hitting even (data) positions
    wo = (wts[1], wts[3])          # taps hitting odd (zero) positions
    n_even = -(-n // 2)            # outputs at even coords
    n_odd = n // 2                 # outputs at odd coords
    # boundary extension on the small grid: up-grid mirror(-2) = 2 -> r[1];
    # mirror(2j) for 2j > n-1 -> 2(n-1) - 2j, giving r[n-1-src] at j = src
    edge = n - 1 - src

    def ext(a, axis):
        lo = jnp.take(a, jnp.asarray([1]), axis=axis)
        hi = jnp.take(a, jnp.asarray([edge]), axis=axis)
        return jnp.concatenate([lo, a, hi], axis=axis)

    def phase_conv(a, axis):
        """-> (even-phase, odd-phase) along `axis`."""
        e = ext(a, axis)
        sl = [slice(None)] * a.ndim

        def take(start, count):
            s = list(sl)
            s[axis] = slice(start, start + count)
            return e[tuple(s)]

        ph0 = (we[0] * take(0, n_even) + we[1] * take(1, n_even)
               + we[2] * take(2, n_even))
        ph1 = wo[0] * take(1, n_odd) + wo[1] * take(2, n_odd)
        return ph0, ph1

    def interleave(a, b, axis, total):
        """a provides even positions, b odd; |a| >= |b|."""
        if b.shape[axis] < a.shape[axis]:
            pad = [(0, 0)] * a.ndim
            pad[axis] = (0, a.shape[axis] - b.shape[axis])
            b = jnp.pad(b, pad)
        st = jnp.stack([a, b], axis=axis + 1 if axis >= 0 else a.ndim + axis + 1)
        shape = list(a.shape)
        ax = axis if axis >= 0 else a.ndim + axis
        shape[ax] = a.shape[ax] * 2
        out = st.reshape(shape[:ax] + [shape[ax]] + shape[ax + 1:])
        s = [slice(None)] * len(shape)
        s[ax] = slice(0, total)
        return out[tuple(s)]

    # rows (axis -2), then columns (axis -1) of each row phase
    r0, r1 = phase_conv(r, r.ndim - 2)
    a00, a01 = phase_conv(r0, r.ndim - 1)
    a10, a11 = phase_conv(r1, r.ndim - 1)
    gain = jnp.asarray(4.0, img.dtype)
    rows_even = interleave(a00, a01, -1, n) * gain
    rows_odd = interleave(a10, a11, -1, n) * gain
    return interleave(rows_even, rows_odd, -2, n)
