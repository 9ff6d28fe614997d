"""Piecewise quadratic-bezier curve LUTs and their evaluation.

The reference stores curves as explicit (x, y) point lists in storage buffers
and evaluates them with a first-match linear search per pixel
(``getY``, shaders/contrast_curve_apply.comp:27-36).  Here curve generation is
a handful of scalar jnp ops (the points are functions of traced histogram
statistics), and ``curve_get_y`` is an unrolled compare/select chain over the
statically-sized point list -- XLA fuses it into a single elementwise pass,
so evaluating a 33-point curve over a 3072^2 image is one elementwise
sweep.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import MusicaConfig

F32 = jnp.float32


def bezier_points(start, middle, end, inclusive: bool):
    """Quadratic bezier sampled at t = i/10 (double-lerp form).

    ``inclusive=True``: 11 points, i <= 10 (contrast_curve_generate.comp:40);
    ``inclusive=False``: 10 points, i < 10 (gradation_curve_generate.comp:31).
    start/middle/end are (x, y) tuples of traced or static f32 scalars.
    Returns (px[k], py[k]) stacked arrays.
    """
    count = 11 if inclusive else 10
    t = jnp.arange(count, dtype=F32) / F32(10.0)
    sx, sy = [jnp.asarray(v, F32) for v in start]
    mx, my = [jnp.asarray(v, F32) for v in middle]
    ex, ey = [jnp.asarray(v, F32) for v in end]
    xa = sx + (mx - sx) * t
    ya = sy + (my - sy) * t
    xb = mx + (ex - mx) * t
    yb = my + (ey - my) * t
    return xa + (xb - xa) * t, ya + (yb - ya) * t


def contrast_curve(max_bin: jnp.ndarray, low_contrast_factor: float,
                   high_contrast_factor: float, cfg: MusicaConfig):
    """Per-level contrast LUT (shaders/contrast_curve_generate.comp:56-90).

    ``low_contrast_factor == 1.0`` (a static Python float per level) selects
    the flat 2-point latitude-reduction line; otherwise 3 bezier segments (33
    points) around maxBinPosition = maxBin / 2048 * 0.1.
    """
    lcf = F32(low_contrast_factor)
    hcf = F32(high_contrast_factor)
    if low_contrast_factor == 1.0:
        px = jnp.array([0.0, 1.0], F32)
        py = jnp.stack([hcf, hcf])
        return px, py
    # stepwise f32 rounding: (maxBin * (1/2048)) * 0.1
    p = (max_bin.astype(F32) * F32(1.0 / cfg.noise_histogram_bins)
         * F32(cfg.max_noise_value))
    one = F32(1.0)
    # left-associated products as the GLSL writes them ((p * 7) / 5.0 etc.);
    # folding the constants changes the f32 rounding by 1 ulp
    p45 = p * F32(4.0) / F32(5.0)
    p65 = p * F32(6.0) / F32(5.0)
    p75 = p * F32(7.0) / F32(5.0)
    l45 = lcf * F32(4.0) / F32(5.0)
    seg1 = bezier_points((F32(0.0), one), (p45, lcf), (p, lcf), True)
    seg2 = bezier_points((p, lcf), (p65, lcf), (p75, l45), True)
    seg3 = bezier_points((p75, l45), (p * F32(2.0), one), (one, one), True)
    px = jnp.concatenate([seg1[0], seg2[0], seg3[0]])
    py = jnp.concatenate([seg1[1], seg2[1], seg3[1]])
    return px, py


def curve_get_y(px: jnp.ndarray, py: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """First-match piecewise-linear lookup, transcribing the GLSL getY exactly
    (shaders/contrast_curve_apply.comp:27-36):

    for i in [0, count): if px[i] == x -> py[i];
                         if px[i] <= x <= px[i+1] -> lerp (px[count] reads 0);
    no match -> 0.0.
    """
    n = px.shape[0]
    px_e = jnp.concatenate([px, jnp.zeros((1,), F32)])
    py_e = jnp.concatenate([py, jnp.zeros((1,), F32)])
    x = x.astype(F32)
    result = jnp.zeros_like(x)
    found = jnp.zeros(x.shape, bool)
    for i in range(n):
        exact = (px_e[i] == x) & ~found
        result = jnp.where(exact, py_e[i], result)
        found = found | exact
        seg = (px_e[i] <= x) & (px_e[i + 1] >= x) & ~found
        m = (py_e[i + 1] - py_e[i]) / (px_e[i + 1] - px_e[i])
        val = m * (x - px_e[i]) + py_e[i]
        result = jnp.where(seg, val, result)
        found = found | seg
    return result


def curve_get_y_sorted(px: jnp.ndarray, py: jnp.ndarray,
                       x: jnp.ndarray) -> jnp.ndarray:
    """curve_get_y for non-decreasing px, as disjoint LEFT-open interval
    selects (no `found` dependency chain, no gathers).

    Equivalence with the first-match scan on sorted px: the scan's exact-x
    branch only ever fires at i == 0 (for any later j, segment j-1's test
    ``px[j-1] <= x <= px[j]`` catches ``x == px[j]`` first and returns the
    LEFT segment's lerp -- note: NOT py[j]); every other x falls in exactly
    one interval (px_i, px_{i+1}] (zero-width duplicate segments never
    match); x outside (px_0, px_last] yields 0.0 except x == px_0 -> py_0
    (the reference's fallthrough/ext-zero read).
    Fewer elementwise ops than curve_get_y and no cross-iteration
    dependency chain.  (A value-carrying tournament tree was tried on an
    earlier platform and was slower: XLA materialized the tree's carried
    intermediates instead of fusing them into one elementwise pass.)

    Evaluated as a LAST-TRUE-WINS select chain over ``lt[i] = px[i] < x``:
    px non-decreasing makes lt monotone non-increasing in i, so the unique
    matching interval ``lt[i] & ~lt[i+1]`` is simply the LAST i with lt[i]
    true.  Zero-width duplicate intervals at segment joins can never be the
    last true index (lt[j] == lt[j+1] there), matching the
    disjoint-interval formulation; x beyond px[-1] falls to 0.0 via the
    final lt[n-1] select.

    The chain selects the matching interval's SCALARS (slope m, px, py) --
    3 selects + 1 compare per interval -- and evaluates ONE lerp on the
    selected triple, instead of evaluating every interval's lerp and
    selecting values (1 compare + sub/mul/add + select per interval):
    ~130 -> ~110 ops/pixel for the 33-point contrast curve.  The
    selected scalars and the final lerp arithmetic are exactly those the
    per-interval evaluation would use, so the result is bit-identical
    (zero-width intervals produce inf/nan slopes but are never selected,
    exactly as their lerp values were computed and never selected before).
    """
    x = x.astype(F32)
    n = px.shape[0]
    lt = [px[i] < x for i in range(n)]
    ms = (py[1:] - py[:-1]) / (px[1:] - px[:-1])

    m_s, px_s, py_s = ms[0], px[0], py[0]
    for i in range(1, n - 1):
        m_s = jnp.where(lt[i], ms[i], m_s)
        px_s = jnp.where(lt[i], px[i], px_s)
        py_s = jnp.where(lt[i], py[i], py_s)
    result = m_s * (x - px_s) + py_s
    result = jnp.where(lt[0], result,
                       jnp.where(x == px[0], py[0], F32(0.0)))
    return jnp.where(lt[n - 1], F32(0.0), result)


def curve_get_y_general(px: jnp.ndarray, py: jnp.ndarray,
                        x: jnp.ndarray) -> jnp.ndarray:
    """First-match getY for ARBITRARY px (shaders/contrast_curve_apply.comp
    :27-36 semantics), branchless, as a DESCENDING scalar-select chain.

    Bit-identical to ``curve_get_y`` for every px shape (verified over 400
    adversarial curves -- fold-backs, duplicate points, exact boundary hits;
    tests/test_ops_golden.py::test_curve_get_y_general_equivalence):

    * Descending overwrite keeps the SMALLEST matching interval = the GLSL
      scan's first match (for sorted px the match is unique, so this also
      equals ``curve_get_y_sorted``).
    * A non-increasing pair px[i+1] <= px[i] -- where the GLSL interval test
      ``px[i] <= x <= px[i+1]`` can never fire but its exact test can --
      becomes a ZERO-WIDTH interval at px[i] via the precomputed scalar
      upper bound ``px_hi[i] = px[i]``.
    * Slope sanitization (m := 0 on non-increasing pairs) makes the GLSL
      exact-match branch's value fall out of the same lerp: at x == px[i],
      ``m * (x - px[i]) + py[i] == py[i]`` exactly for any finite m, and on
      ascending pairs the exact hit is subsumed by the interval hit.
    * No match -> the (0, 0, 0) triple evaluates to exactly +0.0.

    6 ops per interval (2 compares + AND + 3 selects) with one final
    lerp -- and NO runtime ``lax.cond`` (the adaptive cond this replaces
    cost a flat overhead whichever branch ran).
    """
    n = px.shape[0]
    px_e = jnp.concatenate([px, jnp.zeros((1,), F32)])
    py_e = jnp.concatenate([py, jnp.zeros((1,), F32)])
    x = x.astype(F32)
    # The GLSL getY returns 0.0 for ANY unmatched x including NaN/+-inf
    # (every interval test is false), but the no-match (0, 0, 0) triple
    # below lerps to +0.0 only for FINITE x (0 * inf = NaN).  Redirect
    # nonfinite x to a finite sentinel far above every real curve's domain
    # (px is O(1) in this pipeline): it misses every interval and the
    # no-match lerp yields exactly +0.0 -- 2 ops instead of an n-term
    # hit_any chain on the hot tone-map path.
    x = jnp.where(jnp.isfinite(x), x, F32(3.0e38))
    ms = (py_e[1:] - py_e[:-1]) / (px_e[1:] - px_e[:-1])
    nonmono = px_e[1:] <= px_e[:-1]
    m_safe = jnp.where(nonmono, F32(0.0), ms)
    px_hi = jnp.where(nonmono, px_e[:-1], px_e[1:])

    sm = jnp.zeros_like(x)
    spx = jnp.zeros_like(x)
    spy = jnp.zeros_like(x)
    for i in range(n - 1, -1, -1):
        hit = (px_e[i] <= x) & (x <= px_hi[i])
        sm = jnp.where(hit, m_safe[i], sm)
        spx = jnp.where(hit, px_e[i], spx)
        spy = jnp.where(hit, py_e[i], spy)
    return sm * (x - spx) + spy


def curve_get_y_adaptive(px: jnp.ndarray, py: jnp.ndarray,
                         x: jnp.ndarray) -> jnp.ndarray:
    """Faithful getY for runtime-shaped curves (the gradation curve's second
    bezier segment can overshoot t1 when ts > t1, making px non-monotone).

    Now an alias of the branchless ``curve_get_y_general`` chain.  The
    previous formulation dispatched between the sorted and first-match
    chains with a runtime ``lax.cond``, whose own cost exceeded the
    branches' difference; the branchless chain is bit-identical for every
    curve shape.
    """
    return curve_get_y_general(px, py, x)


def curve_apply_u8_adaptive(px: jnp.ndarray, py: jnp.ndarray,
                            x: jnp.ndarray) -> jnp.ndarray:
    """``clip(trunc(255 * getY(px, py, x)))`` as uint8 in one fused
    elementwise pass (the crop-first tone map + quantization), using the
    branchless general chain -- bit-identical to quantizing either
    lax.cond branch of the old adaptive dispatch."""
    g = curve_get_y_general(px, py, x)
    return jnp.clip(jnp.trunc(F32(255.0) * g), 0.0, 255.0).astype(jnp.uint8)


def contrast_curve_apply(bandpass: jnp.ndarray, sdev: jnp.ndarray,
                         px: jnp.ndarray, py: jnp.ndarray) -> jnp.ndarray:
    """out = bandpass * curveY(sdev) (shaders/contrast_curve_apply.comp:38-63).

    The contrast curves' px is provably non-decreasing (bezier controls lie
    between segment endpoints), so the cheaper sorted-interval getY applies.
    """
    return bandpass * curve_get_y_sorted(px, py, sdev)
