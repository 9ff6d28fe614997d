"""Unit tests: every JAX op against the pure-NumPy golden model (the
quirk-exact transcription of the reference's GLSL shaders)."""

import numpy as np
import pytest

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import (
    curves, gradation, noise, normalize, pyramid, stats,
)


def rand_img(rng, n, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, (n, n)).astype(np.float32)


# ----------------------------------------------------------------------
# normalize
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 96, 100, 512])
def test_global_max_min_quirks(rng, n):
    img = (rng.uniform(0, 65535, (n, n))).astype(np.uint16)
    s = golden.img_sqrt(img)
    gmax, gmin = golden.global_max(s), golden.global_min(s)
    jmax = float(normalize.global_max(jnp.asarray(s)))
    jmin = float(normalize.global_min(jnp.asarray(s)))
    assert jmax == gmax
    assert jmin == gmin
    # the truncation quirk: max is an integer <= true max
    assert jmax == np.trunc(jmax) and jmax <= s.max()


def test_min_collapses_to_zero_for_misaligned_chain(rng):
    # 512 -> 64 -> 8 -> 1 is aligned; 384 -> 48 -> 6 -> 1 is not (6 < 8)
    img = rng.uniform(100.0, 200.0, (384, 384)).astype(np.float32)
    assert float(normalize.global_min(jnp.asarray(img))) == 0.0
    img2 = rng.uniform(100.0, 200.0, (512, 512)).astype(np.float32)
    assert float(normalize.global_min(jnp.asarray(img2))) == np.trunc(img2.min())


def test_normalize_matches_golden(rng):
    img = (rng.uniform(0, 65535, (128, 128))).astype(np.uint16)
    s = golden.img_sqrt(img)
    vmax, vmin = golden.global_max(s), golden.global_min(s)
    g = golden.img_normalize(s, vmax, vmin)
    j = normalize.img_normalize(jnp.asarray(s), jnp.float32(vmax), jnp.float32(vmin))
    np.testing.assert_allclose(np.asarray(j), g, rtol=1e-6)


# ----------------------------------------------------------------------
# pyramid
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 7, 16, 33, 64, 96])
@pytest.mark.parametrize("gain", [1.0, 4.0])
def test_smooth_matches_golden(rng, n, gain):
    img = rand_img(rng, n)
    g = golden.img_smooth(img, gain)
    j = np.asarray(pyramid.smooth(jnp.asarray(img), gain))
    np.testing.assert_allclose(j, g, rtol=0, atol=4e-6 * gain)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_smooth_tiny_sizes_oob_zero(rng, n):
    # sizes <= 2: single-pass mirror leaves indices out of bounds -> 0 taps
    img = rand_img(rng, n)
    g = golden.img_smooth(img)
    j = np.asarray(pyramid.smooth(jnp.asarray(img)))
    np.testing.assert_allclose(j, g, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [6, 7, 32, 33])
def test_smooth_downsample_fusion(rng, n):
    img = rand_img(rng, n)
    full = np.asarray(pyramid.smooth(jnp.asarray(img)))[::2, ::2]
    fused = np.asarray(pyramid.smooth_downsample(jnp.asarray(img)))
    np.testing.assert_array_equal(full, fused)
    g = golden.img_downsample(golden.img_smooth(img))
    np.testing.assert_allclose(fused, g, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n_out", [6, 7, 9, 32])
def test_upsample(rng, n_out):
    src = -(-n_out // 2)
    img = rand_img(rng, src)
    g = golden.img_upsample(img, n_out)
    j = np.asarray(pyramid.upsample(jnp.asarray(img), n_out))
    np.testing.assert_array_equal(j, g)


def test_pyramid_roundtrip_no_enhancement(rng):
    """BASELINE config 1: decompose -> reconstruct with unit gains ~= identity."""
    img = rand_img(rng, 128)
    x = jnp.asarray(img)
    bandpass, downs = [], []
    cur = x
    for _ in range(7):
        dn = pyramid.smooth_downsample(cur)
        low = pyramid.upsample_smooth(dn, cur.shape[-1])
        bandpass.append(cur - low)
        downs.append(dn)
        cur = dn
    recon = downs[-1]
    for i in range(7):
        lvl = 6 - i
        recon = pyramid.upsample_smooth(recon, bandpass[lvl].shape[-1]) + bandpass[lvl]
    np.testing.assert_allclose(np.asarray(recon), img, rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# stats
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 33, 96])
def test_sdev_matches_golden(rng, n):
    img = rand_img(rng, n, -0.5, 0.5)
    g = golden.img_sdev(img)
    j = np.asarray(stats.img_sdev(jnp.asarray(img)))
    np.testing.assert_allclose(j, g, rtol=0, atol=2e-6)


def test_fixed_histogram_matches_bincount_with_oob(rng):
    bins = rng.integers(-5, 60, 5000).astype(np.int32)
    w = rng.integers(0, 3, 5000).astype(np.float32)
    w[bins < 0] = 0.0
    w[bins >= 50] = 0.0
    a = np.asarray(stats.fixed_histogram(jnp.asarray(bins), jnp.asarray(w), 50))
    ref = np.bincount(bins[(bins >= 0) & (bins < 50)], weights=w[(bins >= 0) & (bins < 50)], minlength=50)
    np.testing.assert_array_equal(a, ref.astype(np.float32))


@pytest.mark.parametrize("zero_frac", [0.1, 0.3])
def test_noise_histogram_break_semantics(rng, zero_frac):
    # cfg coverage (512) exceeds this level image (256): full scan, fast oracle
    cfg = MusicaConfig(image_size=512)
    n = 256
    # values spanning in/out of range and exact zeros to trigger every break
    sd = rng.uniform(0, 0.15, (n, n)).astype(np.float32)
    sd[rng.uniform(size=(n, n)) < zero_frac] = 0.0
    g = golden.noise_histogram(sd, cfg)
    j = np.asarray(stats.noise_histogram(jnp.asarray(sd), cfg))
    np.testing.assert_array_equal(j.astype(np.int64), g)


def test_noise_histogram_small_level_of_large_config(rng):
    # level images smaller than the coverage: scan bounded by the image
    cfg = MusicaConfig(image_size=1024)
    sd = rng.uniform(0, 0.12, (96, 96)).astype(np.float32)
    sd[rng.uniform(size=(96, 96)) < 0.05] = 0.0
    g = golden.noise_histogram(sd, cfg)
    j = np.asarray(stats.noise_histogram(jnp.asarray(sd), cfg))
    np.testing.assert_array_equal(j.astype(np.int64), g)


def test_histogram_max_first_occurrence():
    h = jnp.asarray(np.array([0, 3, 7, 7, 1], np.float32))
    mv, mb = stats.histogram_max(h)
    assert float(mv) == 7 and int(mb) == 2
    g = golden.histogram_max(np.array([0, 3, 7, 7, 1]))
    assert g == (7, 2)


# ----------------------------------------------------------------------
# curves
# ----------------------------------------------------------------------

@pytest.mark.parametrize("max_bin", [0, 1, 57, 555, 2047])
def test_contrast_curve_fine_levels(max_bin):
    cfg = MusicaConfig(image_size=512)
    lcf, hcf = cfg.contrast_factors[0]
    gpx, gpy = golden.contrast_curve_generate(max_bin, lcf, hcf, cfg)
    jpx, jpy = curves.contrast_curve(jnp.int32(max_bin), lcf, hcf, cfg)
    np.testing.assert_allclose(np.asarray(jpx), gpx, rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(jpy), gpy, rtol=0, atol=1e-7)
    assert len(gpx) == 33


def test_contrast_curve_flat():
    cfg = MusicaConfig(image_size=512)
    lcf, hcf = cfg.contrast_factors[5]
    assert lcf == 1.0
    gpx, gpy = golden.contrast_curve_generate(0, lcf, hcf, cfg)
    jpx, jpy = curves.contrast_curve(jnp.int32(0), lcf, hcf, cfg)
    np.testing.assert_array_equal(np.asarray(jpx), gpx)
    np.testing.assert_array_equal(np.asarray(jpy), gpy)
    assert len(gpx) == 2


def test_curve_get_y_matches_golden(rng):
    cfg = MusicaConfig(image_size=512)
    lcf, hcf = cfg.contrast_factors[1]
    px, py = golden.contrast_curve_generate(400, lcf, hcf, cfg)
    # probe: exact hits, between points, beyond 1.0 (-> 0), negatives (-> 0)
    xs = np.concatenate([
        px[::3], rng.uniform(0, 1, 500).astype(np.float32),
        np.array([1.5, 2.0, -0.1, 0.0, 1.0], np.float32)])
    g = golden.curve_get_y(px, py, xs)
    j = np.asarray(curves.curve_get_y(jnp.asarray(px), jnp.asarray(py), jnp.asarray(xs)))
    np.testing.assert_allclose(j, g, rtol=0, atol=1e-6)
    assert g[-4] == 0.0 and g[-5] == 0.0  # x > 1 falls through to 0


# ----------------------------------------------------------------------
# noise / relevance
# ----------------------------------------------------------------------

def test_cnr_matches_golden(rng):
    cfg = MusicaConfig(image_size=512)
    sd = rand_img(rng, 64, 0, 0.05)
    for mb in [0, 100]:
        g = golden.img_cnr(sd, mb, cfg)
        j = np.asarray(noise.img_cnr(jnp.asarray(sd), jnp.int32(mb), cfg))
        np.testing.assert_allclose(j, g, rtol=1e-6)


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_noise_reduction_matches_golden(rng, lvl):
    cfg = MusicaConfig(image_size=512)
    lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[lvl]
    band = rand_img(rng, 512 >> lvl, -0.3, 0.3)
    cnr = rand_img(rng, 64, 0, 0.08)  # cnr*256 spans 0..20: hits both clamps
    g = golden.noise_reduction(band, cnr, lo_c, lo_f, hi_c, hi_f, cfg)
    j = np.asarray(noise.noise_reduction(jnp.asarray(band), jnp.asarray(cnr),
                                         lo_c, lo_f, hi_c, hi_f, cfg))
    np.testing.assert_allclose(j, g, rtol=0, atol=3e-6)


def test_noise_reduction_ramp_is_anchored_at_zero():
    """The GLSL quirk: factor(cnr) = m*cnr + lowFactor inside the ramp."""
    cfg = MusicaConfig(image_size=512)
    band = np.ones((8, 8), np.float32)
    cnr = np.full((8, 8), 6.0 / 256.0, np.float32)  # cnr = 6 (mid-ramp)
    out = np.asarray(noise.noise_reduction(jnp.asarray(band), jnp.asarray(cnr),
                                           3.0, 0.6, 9.0, 1.2, cfg))
    np.testing.assert_allclose(out, 0.1 * 6.0 + 0.6, rtol=1e-6)


def test_relevant_matches_golden(rng):
    cfg = MusicaConfig(image_size=512, relevant_border=20)
    norm = rand_img(rng, 256, 0, 1.0)
    cnr = rand_img(rng, 32, 0, 0.1)
    g = golden.img_relevant(norm, cnr, cfg)
    j = np.asarray(noise.img_relevant(jnp.asarray(norm), jnp.asarray(cnr), cfg))
    np.testing.assert_allclose(j, g, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# gradation
# ----------------------------------------------------------------------

@pytest.mark.parametrize("zero_frac", [0.02, 0.005])
def test_gradation_histogram_return_semantics(rng, zero_frac):
    cfg = MusicaConfig(image_size=256)
    n = 256
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(np.float32)
    recon[rng.uniform(size=(n, n)) < zero_frac] = 0.0  # zeros abort tiles
    relevant = (rng.uniform(0, 1, (n, n)) ** 2).astype(np.float32)
    g = golden.gradation_histogram(recon, relevant, cfg)
    j = np.asarray(gradation.gradation_histogram(
        jnp.asarray(recon), jnp.asarray(relevant), cfg))
    np.testing.assert_array_equal(j.astype(np.int64), g)


def test_gradation_curve_matches_golden(rng):
    cfg = MusicaConfig(image_size=512)
    hist = (rng.gamma(2.0, 200.0, 1024) *
            np.exp(-((np.arange(1024) - 400) / 150.0) ** 2)).astype(np.int64) * 100
    hist[:10] = 12345  # below lowest relevant bin: ignored by stats
    gpx, gpy, gt = golden.gradation_curve_generate(hist, cfg)
    jpx, jpy, jt = gradation.gradation_curve(jnp.asarray(hist, jnp.int64), cfg)
    np.testing.assert_allclose(np.asarray(jpx), gpx, rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(jpy), gpy, rtol=0, atol=1e-7)
    for a, b in zip(jt, gt):
        assert abs(float(a) - b) < 1e-7
    assert len(gpx) == 22


def test_gradation_curve_empty_histogram():
    cfg = MusicaConfig(image_size=512)
    hist = np.zeros(1024, np.int64)
    gpx, gpy, gt = golden.gradation_curve_generate(hist, cfg)
    jpx, jpy, jt = gradation.gradation_curve(jnp.asarray(hist, jnp.int64), cfg)
    np.testing.assert_allclose(np.asarray(jpx), gpx, rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(jpy), gpy, rtol=0, atol=1e-7)


def test_gradation_curve_uint32_wraparound():
    """Huge weighted mean accumulators must wrap as the GLSL uint does."""
    cfg = MusicaConfig(image_size=512)
    hist = np.full(1024, 9_000_000 * 100, np.int64)  # sum(count*i) >> 2^32
    gpx, gpy, gt = golden.gradation_curve_generate(hist, cfg)
    jpx, jpy, jt = gradation.gradation_curve(jnp.asarray(hist, jnp.int64), cfg)
    np.testing.assert_allclose(np.asarray(jpx), gpx, rtol=0, atol=1e-7)
    for a, b in zip(jt, gt):
        assert abs(float(a) - b) < 1e-7


def test_curve_get_y_sorted_matches_unrolled(rng):
    cfg = MusicaConfig(image_size=512)
    for max_bin in [0, 1, 57, 555, 2047]:
        for lvl in [0, 1, 2, 5]:
            lcf, hcf = cfg.contrast_factors[lvl]
            px, py = curves.contrast_curve(jnp.int32(max_bin), lcf, hcf, cfg)
            pxn = np.asarray(px)
            xs = np.concatenate([
                pxn, np.nextafter(pxn, 2, dtype=np.float32),
                np.nextafter(pxn, -1, dtype=np.float32),
                rng.uniform(0, 1, 400).astype(np.float32),
                np.array([0.0, 1.0, 1.0000001, 2.0, -0.5], np.float32)])
            a = np.asarray(curves.curve_get_y(px, py, jnp.asarray(xs)))
            b = np.asarray(curves.curve_get_y_sorted(px, py, jnp.asarray(xs)))
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_out", [6, 7, 9, 12, 33, 64, 97, 256])
def test_upsample_smooth_polyphase_bitexact(rng, n_out):
    """The polyphase lowpass must be BIT-identical to smooth(upsample(...))
    (skipped taps are exact zero products)."""
    src = -(-n_out // 2)
    img = rand_img(rng, src)
    ref = np.asarray(pyramid.smooth(pyramid.upsample(jnp.asarray(img), n_out),
                                    gain=4.0))
    got = np.asarray(pyramid.upsample_smooth(jnp.asarray(img), n_out))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [96, 100, 384, 512])
def test_normalize_from_u16_bitexact(rng, n):
    img = (rng.uniform(0, 65535, (n, n))).astype(np.uint16)
    s = golden.img_sqrt(img)
    vmax, vmin = golden.global_max(s), golden.global_min(s)
    ref = golden.img_normalize(s, vmax, vmin)
    got, jmax, jmin = normalize.normalize_from_u16(jnp.asarray(img))
    assert float(jmax) == vmax and float(jmin) == vmin
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_curve_get_y_adaptive_nonmonotone_fallback(rng):
    """A gradation curve whose second bezier segment overshoots t1 (ts > t1)
    has non-monotone px; the adaptive lookup must then match the first-match
    chain."""
    ta, ts, t1 = 0.3, 0.467, 0.32  # control beyond the endpoint
    seg1 = curves.bezier_points((0.0, 0.0), (0.13, 0.0), (ta, 0.5), False)
    seg2 = curves.bezier_points((ta, 0.5), (ts, 1.0), (t1, 1.0), False)
    px = jnp.concatenate([jnp.zeros((1,), jnp.float32), seg1[0], seg2[0],
                          jnp.ones((1,), jnp.float32)])
    py = jnp.concatenate([jnp.zeros((1,), jnp.float32), seg1[1], seg2[1],
                          jnp.ones((1,), jnp.float32)])
    pxn = np.asarray(px)
    assert (np.diff(pxn) < 0).any(), "test needs a non-monotone curve"
    xs = jnp.asarray(np.concatenate(
        [pxn, rng.uniform(0, 1, 500).astype(np.float32)]))
    a = np.asarray(curves.curve_get_y(px, py, xs))
    b = np.asarray(curves.curve_get_y_adaptive(px, py, xs))
    # both run the chain; XLA FMA contraction may differ per fusion context
    np.testing.assert_allclose(a, b, rtol=0, atol=3e-7)


def test_curve_get_y_adaptive_monotone(rng):
    cfg = MusicaConfig(image_size=512)
    lcf, hcf = cfg.contrast_factors[1]
    px, py = curves.contrast_curve(jnp.int32(400), lcf, hcf, cfg)
    xs = jnp.asarray(rng.uniform(0, 1.1, 800).astype(np.float32))
    a = np.asarray(curves.curve_get_y(px, py, xs))
    b = np.asarray(curves.curve_get_y_adaptive(px, py, xs))
    # sorted-interval picks the identical segment; allow FMA-contraction ulps
    np.testing.assert_allclose(a, b, rtol=0, atol=3e-7)


def test_curve_get_y_general_equivalence(rng):
    """The branchless general chain must match the first-match scan
    BIT-exactly for arbitrary px shapes: sorted, fold-back tails (the
    gradation ts > t1 overshoot family), duplicate points, exact boundary
    hits and 1-ulp neighbors, out-of-range x, and nonfinite x (NaN/inf
    must yield 0.0 like the GLSL no-match path, not 0*inf = NaN).

    xs is padded to ONE static length so the 120 trials hit at most 32
    compile shapes (two fns x n in [2, 34)) instead of recompiling every
    trial -- same adversarial coverage, ~4x less suite wall time."""
    XLEN = 64 + 3 * 33 + 6
    for trial in range(120):
        n = int(rng.integers(2, 34))
        pxs = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
        if trial % 3 == 1 and n > 4:  # fold-back tail, re-rise to 1.0
            k = int(rng.integers(1, n - 1))
            pxs[k:] = (pxs[k] - np.abs(pxs[k:] - pxs[k]) * 0.5
                       ).astype(np.float32)
            pxs[-1] = 1.0
        if trial % 5 == 2 and n > 3:  # zero-width duplicate interval
            pxs[n // 2] = pxs[n // 2 - 1]
        if trial % 7 == 3:
            pxs[0] = 0.0
        pys = rng.uniform(0, 1, n).astype(np.float32)
        xs = np.concatenate([
            rng.uniform(-0.1, 1.1, 64).astype(np.float32), pxs,
            np.nextafter(pxs, 2, dtype=np.float32),
            np.nextafter(pxs, -1, dtype=np.float32),
            np.array([0.0, 1.0, pxs[-1], np.nan, np.inf, -np.inf],
                     np.float32)]).astype(np.float32)
        xs = np.concatenate([
            xs, rng.uniform(-0.1, 1.1, XLEN - len(xs)).astype(np.float32)])
        a = np.asarray(curves.curve_get_y(jnp.asarray(pxs), jnp.asarray(pys),
                                          jnp.asarray(xs)))
        b = np.asarray(curves.curve_get_y_general(
            jnp.asarray(pxs), jnp.asarray(pys), jnp.asarray(xs)))
        np.testing.assert_array_equal(a, b)
        assert not np.isnan(b).any()
