"""End-to-end pipeline tests: JAX pipeline vs the NumPy golden model, plus
basic output sanity."""

import numpy as np
import pytest

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden, musica


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return np.inf
    return 10 * np.log10(255.0 ** 2 / mse)


def test_full_pipeline_matches_golden(phantom_512):
    cfg = MusicaConfig(image_size=512)
    g_out, g_inter = golden.process(phantom_512, cfg, return_intermediates=True)
    j_out = musica.process(phantom_512, cfg)
    assert j_out.shape == g_out.shape == (492, 492)
    # stage-level agreement is float-exact modulo conv accumulation order;
    # at u8 output the two must be essentially identical
    p = psnr(j_out, g_out)
    assert p > 55.0, f"PSNR vs golden only {p:.1f} dB"
    # the vast majority of pixels must match bit-exactly (off-by-one u8
    # rounding allowed on a small fraction)
    frac_exact = np.mean(j_out == g_out)
    assert frac_exact > 0.98, frac_exact
    assert np.max(np.abs(j_out.astype(int) - g_out.astype(int))) <= 2


def test_pipeline_intermediates_match_golden(phantom_512):
    import jax
    cfg = MusicaConfig(image_size=512)
    _, g = golden.process(phantom_512, cfg, return_intermediates=True)
    res = jax.jit(lambda im: musica.musica_forward(im, cfg, want_intermediates=True),
                  )(jnp.asarray(phantom_512))
    inter = res["intermediates"]

    np.testing.assert_allclose(np.asarray(inter["normalized"]),
                               g["normalized"], rtol=0, atol=1e-6)
    for i in range(cfg.pyramid_levels):
        np.testing.assert_allclose(
            np.asarray(inter[f"red_bandpass_{i}"]), g["bandpass"][i],
            rtol=0, atol=5e-5, err_msg=f"bandpass level {i}")
    for i in g["sdev"]:
        np.testing.assert_allclose(
            np.asarray(inter[f"sdev_{i}"]), g["sdev"][i],
            rtol=0, atol=5e-5, err_msg=f"sdev level {i}")
    # histogram argmax bins must agree exactly for curve parity
    for i, mb in g["noise_max_bins"].items():
        assert int(inter[f"noise_max_bin_{i}"]) == mb, f"level {i}"
    # pow() is a transcendental: numpy vs XLA differ by ~1e-4 in the
    # (cnr/6)^5 ramp (the GLSL pow is itself approximate)
    np.testing.assert_allclose(np.asarray(inter["relevant"]), g["relevant"],
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(np.asarray(res["cnr"]), g["cnr"],
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.asarray(res["recon"]), g["recon"],
                               rtol=0, atol=2e-4)
    # gradation window parameters
    gt = g["grad_curve"][2]
    jt = inter["grad_curve"][2]
    for a, b in zip(jt, gt):
        assert abs(float(a) - b) < 1e-5


def test_batch_matches_single(phantom_256):
    cfg = MusicaConfig(image_size=256)
    single = musica.process(phantom_256, cfg)
    batch = np.asarray(musica.process_batch_jit(
        jnp.asarray(np.stack([phantom_256, phantom_256])), cfg))
    np.testing.assert_array_equal(batch[0], single)
    np.testing.assert_array_equal(batch[1], single)


def test_batch_interleave_bit_identical(phantom_256, rng):
    """interleave=g traces g independent single-image programs per map body
    (schedule-bubble filling); outputs must be
    bit-identical to the sequential lax.map path for distinct inputs.
    128 px: the grouping/reduction semantics are size-independent and each
    g value costs a batch-program compile (1-core cold-suite budget)."""
    cfg = MusicaConfig(image_size=128)
    imgs = np.stack([
        np.asarray(phantom_256)[:128, :128],
        np.asarray(phantom_256)[::2, ::2].copy(),
        rng.integers(0, 60000, (128, 128)).astype(np.uint16),
        np.asarray(phantom_256)[::-2, ::-2].copy(),
    ])
    xb = jnp.asarray(imgs)
    seq = np.asarray(musica.process_batch_jit(xb, cfg, interleave=1))
    for g in (2, 4):
        inter = np.asarray(musica.process_batch_jit(xb, cfg, interleave=g))
        np.testing.assert_array_equal(inter, seq, err_msg=f"interleave={g}")
    # the default (g=4) is one of the above
    dflt = np.asarray(musica.process_batch_jit(xb, cfg))
    np.testing.assert_array_equal(dflt, seq)
    # non-divisible batches reduce g to the largest divisor (B=3, g=2 -> 1)
    assert musica._effective_interleave(3, 2) == 1
    assert musica._effective_interleave(6, 4) == 3
    odd = np.asarray(musica.process_batch_jit(xb[:3], cfg, interleave=2))
    np.testing.assert_array_equal(odd, seq[:3])


def test_output_properties(phantom_512):
    cfg = MusicaConfig(image_size=512)
    out = musica.process(phantom_512, cfg)
    assert out.dtype == np.uint8
    assert out.shape == (492, 492)
    # enhancement should produce a usable dynamic range on the phantom
    assert out.max() > 200 and out.min() < 50


def test_quirks_off_is_close_but_not_identical(phantom_512):
    cfg_q = MusicaConfig(image_size=512, quirks=True)
    cfg_c = MusicaConfig(image_size=512, quirks=False)
    a = musica.process(phantom_512, cfg_q)
    b = musica.process(phantom_512, cfg_c)
    # same algorithm family: outputs correlate strongly
    assert psnr(a, b) > 25.0


def test_linear_gradation_matches_golden(phantom_512):
    cfg = MusicaConfig(image_size=512, grad_with_linear_image=True)
    g_out = golden.process(phantom_512, cfg)
    j_out = musica.process(phantom_512, cfg)
    assert psnr(j_out, g_out) > 55.0
    assert np.mean(j_out == g_out) > 0.98


def test_odd_size_pipeline_matches_golden():
    """600 px: ragged pyramid (600,300,150,75,38,19,10,5,3,2), noise-hist
    coverage quirk (512 < 600), tiny-level mirror OOB smooths."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph
    img = synthetic_radiograph(600, "pelvis")
    cfg = MusicaConfig(image_size=600)
    assert cfg.hist_coverage == 512
    g_out = golden.process(img, cfg)
    j_out = musica.process(img, cfg)
    assert j_out.shape == g_out.shape == (580, 580)
    assert psnr(j_out, g_out) > 55.0
    assert np.mean(j_out == g_out) > 0.98


@pytest.mark.parametrize("variant",
                         ["default", "clahe", "linear", "clahe_linear"])
def test_timed_process_matches_untimed(phantom_256, variant):
    """timed_process must run the CONFIGURED variant (the reference's
    MEASURE_PROCESS fences the real pass, src/vk_processing.cpp:2580-2596):
    the per-phase fenced execution's output must be bit-identical to
    musica_forward's for every variant (round-3 regression: the timed grad
    phase ignored enable_clahe).  256 px: the check is phase-WIRING
    equality, which is size-independent (suite budget)."""
    import jax

    cfg = MusicaConfig(image_size=256,
                       enable_clahe=("clahe" in variant),
                       grad_with_linear_image=("linear" in variant))
    res = jax.jit(lambda im: musica.musica_forward(im, cfg))(
        jnp.asarray(phantom_256))
    timed_out, times, extras = musica.timed_process(
        phantom_256, cfg, want_extras=True)
    ref_out = np.asarray(res["out_u8"])
    if "linear" in variant:
        # recon*recon crosses a jit-partition boundary in the timed path:
        # XLA's FMA contraction differs, flipping u8 truncation on isolated
        # pixels (observed 1/242064) -- same class as docs/QUIRKS.md #29
        diff = timed_out.astype(int) - ref_out.astype(int)
        assert np.abs(diff).max() <= 1
        assert np.mean(diff != 0) < 1e-4, np.mean(diff != 0)
    else:
        np.testing.assert_array_equal(timed_out, ref_out)
    assert set(times) == {"norm", "red", "anly", "aply", "exp", "grad", "tot"}
    assert all(v >= 0 for v in times.values())
    if "clahe" in variant:
        # the CDF-blend accumulation order differs across jit partition
        # boundaries (fusion choice): 1-2 ulp of the f32 LUT, not semantic
        np.testing.assert_allclose(extras["clahe_graded"],
                                   np.asarray(res["clahe_graded"]),
                                   rtol=0, atol=2e-6)
    else:
        assert extras == {}


