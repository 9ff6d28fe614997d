"""CLAHE variant tests against the golden oracle (models/golden.py
clahe_histograms / clahe_curves / clahe_apply / clahe_grade -- loop-level
NumPy transcriptions of shaders/clahe_histogram.comp, clahe_grad_curve.comp,
clahe_grad_curve_apply.comp)."""

import numpy as np
import pytest

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import clahe


def test_clahe_histograms_match_golden(rng):
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    recon = rng.uniform(-0.1, 1.1, (128, 128)).astype(np.float32)
    relevant = (rng.uniform(size=(128, 128)) < 0.5).astype(np.float32)
    g = golden.clahe_histograms(recon, relevant, cfg)
    j = np.asarray(clahe.clahe_histograms(jnp.asarray(recon),
                                          jnp.asarray(relevant), cfg))
    np.testing.assert_array_equal(j.astype(np.int64), g)


def test_clahe_curves_match_golden(rng):
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    h = rng.integers(0, 500, (4, 4, 256)).astype(np.int64)
    gpx, gpy = golden.clahe_curves(h, cfg)
    jpx, jpy = clahe.clahe_curves(jnp.asarray(h, jnp.int32).astype(jnp.float32), cfg)
    # golden is the sequential-f32 GLSL loop; the jnp path uses vectorized
    # cumsum whose accumulation order may differ within f32 rounding
    np.testing.assert_allclose(np.asarray(jpx), gpx, atol=1e-7)
    np.testing.assert_allclose(np.asarray(jpy), gpy, rtol=0, atol=1e-4)
    # CDF ends at ~1
    assert np.allclose(np.asarray(jpy)[..., -1], 1.0, atol=1e-3)


def test_clahe_lut_eval_matches_golden_get_y(rng):
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    h = rng.integers(0, 500, (4, 4, 256)).astype(np.int64)
    px, py = golden.clahe_curves(h, cfg)
    xs = np.concatenate([rng.uniform(0, 1, 200),
                         [0.0, 1.0, 0.5, 255 / 256, -0.2, 1.3]]).astype(np.float32)
    ref = golden.curve_get_y(px.astype(np.float32), py[2, 1].astype(np.float32), xs)
    got = np.asarray(clahe._lut_eval(
        jnp.asarray(px, jnp.float32),
        jnp.asarray(py, jnp.float32).reshape(-1),
        jnp.full(xs.shape, 2 * 4 + 1, jnp.int32),
        jnp.asarray(xs), cfg.clahe_bins))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_clahe_apply_matches_golden(rng):
    """Full-image blended apply vs the golden per-pixel transcription."""
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    recon = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    relevant = (rng.uniform(size=(128, 128)) < 0.8).astype(np.float32)
    h = golden.clahe_histograms(recon, relevant, cfg)
    px, py = golden.clahe_curves(h, cfg)
    ref = golden.clahe_apply(recon, px, py, cfg)
    got = np.asarray(clahe.clahe_apply(
        jnp.asarray(recon), jnp.asarray(px), jnp.asarray(py), cfg))
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5)


def test_clahe_grade_matches_golden(rng):
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    recon = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    relevant = np.ones((128, 128), np.float32)
    ref = golden.clahe_grade(recon, relevant, cfg)
    got = np.asarray(clahe.clahe_grade(jnp.asarray(recon),
                                       jnp.asarray(relevant), cfg))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_clahe_apply_edge_values_match_golden(rng):
    """The XLA gather apply vs the golden transcription on inputs that hit
    every getY branch: out-of-range pixels (-> 0), exact 1.0 (the clamped
    last LUT point) and tiles left empty by the mask (0/0 CDF -> NaN in
    both, at identical positions)."""
    cfg = MusicaConfig(image_size=256, enable_clahe=True)
    recon = rng.uniform(-0.1, 1.1, (256, 256)).astype(np.float32)
    recon[rng.uniform(size=(256, 256)) < 0.01] = 1.0  # exact-last path
    relevant = (rng.uniform(size=(256, 256)) < 0.7).astype(np.float32)
    relevant[:64, :64] = 0.0  # one empty tile
    h = golden.clahe_histograms(recon, relevant, cfg)
    px, py = golden.clahe_curves(h, cfg)
    ref = golden.clahe_apply(recon, px, py, cfg)
    got = np.asarray(clahe.clahe_apply(jnp.asarray(recon), jnp.asarray(px),
                                       jnp.asarray(py), cfg))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref).any()
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=3e-5)


def test_clahe_histograms_ragged_size_match_golden(rng):
    """An image size that is not a multiple of the tile count (198 over 4
    tiles): the per-pixel tile id uint(x / n * tiles) and the dropped
    out-of-range bins must match the golden transcription exactly."""
    cfg = MusicaConfig(image_size=198, enable_clahe=True)
    recon = rng.uniform(-0.1, 1.1, (198, 198)).astype(np.float32)
    relevant = (rng.uniform(size=(198, 198)) < 0.5).astype(np.float32)
    g = golden.clahe_histograms(recon, relevant, cfg)
    j = np.asarray(clahe.clahe_histograms(jnp.asarray(recon),
                                          jnp.asarray(relevant), cfg))
    np.testing.assert_array_equal(j.astype(np.int64), g)


def test_clahe_apply_center_pixel_identity(rng):
    """At a tile center the blend must equal the single-tile LUT value."""
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    recon = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    relevant = np.ones((128, 128), np.float32)
    h = clahe.clahe_histograms(jnp.asarray(recon), jnp.asarray(relevant), cfg)
    px, py = clahe.clahe_curves(h, cfg)
    out = np.asarray(clahe.clahe_apply(jnp.asarray(recon), px, py, cfg))
    ts = 128 // 4
    cx = ts // 2  # coord/TILE = 0.5 -> diff == 0
    ref = golden.curve_get_y(np.asarray(px), np.asarray(py)[0, 0],
                             np.float32(recon[cx, cx]))
    assert abs(out[cx, cx] - ref) < 1e-5


def test_clahe_grade_dense_mask(rng):
    """With every tile populated the blended output is finite, monotone-ish
    in the input, and within [0, ~1]."""
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    recon = rng.uniform(0.05, 0.95, (128, 128)).astype(np.float32)
    relevant = np.ones((128, 128), np.float32)
    out = np.asarray(clahe.clahe_grade(jnp.asarray(recon),
                                       jnp.asarray(relevant), cfg))
    assert np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0 + 1e-5


def test_clahe_end_to_end_runs(phantom_256):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica
    import jax
    cfg = MusicaConfig(image_size=256, enable_clahe=True)
    res = jax.jit(lambda im: musica.musica_forward(im, cfg))(jnp.asarray(phantom_256))
    cg = np.asarray(res["clahe_graded"])
    assert cg.shape == (256, 256)
    # the regular gradation output must be unaffected by the CLAHE branch
    base = jax.jit(lambda im: musica.musica_forward(
        im, cfg.with_(enable_clahe=False)))(jnp.asarray(phantom_256))
    np.testing.assert_array_equal(np.asarray(res["out_u8"]),
                                  np.asarray(base["out_u8"]))


def test_clahe_full_pipeline_matches_golden(rng):
    """End-to-end pipeline with ENABLE_CLAHE vs the golden full pass at a
    small size (64^2: 4x4 tiles of 16 px)."""
    import jax
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden, musica
    cfg = MusicaConfig(image_size=64, enable_clahe=True)
    img = rng.integers(0, 65535, (64, 64)).astype(np.uint16)
    res = jax.jit(lambda a: musica.musica_forward(a, cfg))(jnp.asarray(img))
    _, inter = golden.process(img, cfg, return_intermediates=True)
    np.testing.assert_allclose(np.asarray(res["clahe_graded"]),
                               inter["clahe_graded"], rtol=0, atol=1e-4)


def test_clahe_with_linear_gradation_interaction(phantom_256):
    """ENABLE_CLAHE x GRAD_WITH_LINEAR_IMAGE: CLAHE always grades the FINAL
    reconstruction (expandImageStates[L-1] binding,
    src/vk_processing.cpp:1903-1906, 1968-1973) while the normal gradation
    histograms/maps the SQUARED linear image (musica.py:111-124) -- the two
    paths must not leak into each other."""
    import jax
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import noise as noise_ops
    cfg = MusicaConfig(image_size=256, enable_clahe=True,
                       grad_with_linear_image=True)
    im = jnp.asarray(phantom_256)
    res = jax.jit(lambda a: musica.musica_forward(a, cfg,
                                                  want_intermediates=True))(im)
    # (a) clahe_graded == clahe_grade(recon, relevant) -- NOT of the squared
    #     linear image
    recon = res["recon"]
    relevant = res["intermediates"]["relevant"]
    expected_clahe = np.asarray(clahe.clahe_grade(recon, relevant, cfg))
    np.testing.assert_array_equal(np.asarray(res["clahe_graded"]),
                                  expected_clahe)
    linear_clahe = np.asarray(clahe.clahe_grade(recon * recon, relevant, cfg))
    assert not np.array_equal(np.asarray(res["clahe_graded"]), linear_clahe)
    # (b) the normal tone-mapped output is untouched by enabling CLAHE
    base = jax.jit(lambda a: musica.musica_forward(
        a, cfg.with_(enable_clahe=False)))(im)
    np.testing.assert_array_equal(np.asarray(res["out_u8"]),
                                  np.asarray(base["out_u8"]))
    # (c) and it IS the linear-domain gradation: differs from the
    #     non-linear-variant output
    nonlin = jax.jit(lambda a: musica.musica_forward(
        a, cfg.with_(enable_clahe=False, grad_with_linear_image=False)))(im)
    assert not np.array_equal(np.asarray(res["out_u8"]),
                              np.asarray(nonlin["out_u8"]))
