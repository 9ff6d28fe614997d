"""The pipeline's histograms (noise, gradation, per-level argmax) vs the
golden model.

These are EXACT-equality comparisons between differently-compiled programs
(strict NumPy golden and XLA-jitted JAX).  XLA's fusion-dependent FP
contraction (FMA / reassociation) can legally move a decision value like
``v/0.1*2048 + 0.5`` by 1 ulp between two compilations of the same formula,
flipping the int truncation for pixels that sit within an ulp of a bin
boundary (the GLSL reference is just as unspecified there —
docs/QUIRKS.md #29).  So each test here (a) uses its own deterministic rng
rather than the shared order-dependent session fixture, and (b) perturbs
pixels whose decision values fall within 1e-3 of a boundary — the tests
target the masks' *logic* (break/return semantics, coverage, bin
factorization), not the contraction behavior of any particular compiler.
"""

import numpy as np

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import gradation, noise, stats

F32 = np.float32


def _snap_noise_bins(sd: np.ndarray, cfg, eps: float = 1e-3) -> np.ndarray:
    """Nudge pixels whose noise-hist decision value ``v/0.1*2048 + 0.5``
    (shaders/noise_hist.comp:31-35) lies within ``eps`` of an integer."""
    sd = sd.copy()
    for _ in range(8):
        t = (sd.astype(F32) / F32(cfg.max_noise_value)) \
            * F32(cfg.noise_histogram_bins) + F32(0.5)
        near = (np.abs(t - np.round(t)) < eps) & (sd > 0)
        if not near.any():
            return sd
        sd[near] *= F32(1.0007)
    raise AssertionError("could not move pixels off bin boundaries")


def _snap_grad_bins(recon: np.ndarray, cfg, eps: float = 1e-3) -> np.ndarray:
    """Nudge pixels whose gradation-hist decision value ``v * 1024``
    (shaders/gradation_histogram.comp:27) lies within ``eps`` of an
    integer truncation boundary."""
    recon = recon.copy()
    for _ in range(8):
        t = recon.astype(F32) * F32(cfg.grad_histogram_bins)
        near = (np.abs(t - np.round(t)) < eps) & (recon != 0)
        if not near.any():
            return recon
        recon[near] += F32(eps / cfg.grad_histogram_bins * 4)
    raise AssertionError("could not move pixels off bin boundaries")


def _snap_weights(relevant: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    """Nudge relevance weights whose ``uint(rel * 100)``
    (shaders/gradation_histogram.comp:30) sits within ``eps`` of a step."""
    relevant = relevant.copy()
    t = relevant.astype(F32) * F32(100.0)
    near = np.abs(t - np.round(t)) < eps
    relevant[near] += F32(0.003)
    return relevant


def _noise_hist(sd, cfg):
    return np.asarray(jax.jit(lambda s: stats.noise_histogram(s, cfg))(
        jnp.asarray(sd)))


def test_noise_hist_matches_golden():
    rng = np.random.default_rng(71)
    cfg = MusicaConfig(image_size=512)
    sd = rng.uniform(0, 0.15, (256, 256)).astype(np.float32)
    sd[rng.uniform(size=(256, 256)) < 0.1] = 0.0
    sd = _snap_noise_bins(sd, cfg)
    np.testing.assert_array_equal(_noise_hist(sd, cfg).astype(np.int64),
                                  golden.noise_histogram(sd, cfg))


def test_noise_hist_small_level_matches_golden():
    """A level smaller than the dispatch coverage (128 of a 1024 config)."""
    rng = np.random.default_rng(72)
    cfg = MusicaConfig(image_size=1024)
    sd = rng.uniform(0, 0.12, (128, 128)).astype(np.float32)
    sd[rng.uniform(size=(128, 128)) < 0.05] = 0.0
    sd = _snap_noise_bins(sd, cfg)
    np.testing.assert_array_equal(_noise_hist(sd, cfg).astype(np.int64),
                                  golden.noise_histogram(sd, cfg))


def test_sdev_then_noise_hist_matches_golden():
    """img_sdev tracks the f64 golden oracle to 2e-6 (1-ulp f32 agreement
    across compilers is not defined -- quirk #29), and the histogram of the
    pipeline's own sdev equals the golden histogram of that same sdev."""
    rng = np.random.default_rng(75)
    cfg = MusicaConfig(image_size=512)
    band = rng.normal(0, 0.02, (512, 512)).astype(np.float32)
    band[rng.uniform(size=(512, 512)) < 0.01] = 0.0
    sd = np.asarray(jax.jit(stats.img_sdev)(jnp.asarray(band)))
    np.testing.assert_allclose(sd, golden.img_sdev(band), rtol=0, atol=2e-6)
    sd = _snap_noise_bins(sd, cfg)
    h = _noise_hist(sd, cfg)
    np.testing.assert_array_equal(h.astype(np.int64),
                                  golden.noise_histogram(sd, cfg))
    assert h.sum() > 0


def test_noise_hist_partial_coverage_matches_golden():
    """A level whose size is not a multiple of the 16-px tile (40 -> the
    dispatch pads to 48): the padded tile columns break immediately."""
    rng = np.random.default_rng(76)
    cfg = MusicaConfig(image_size=512)
    sd = rng.uniform(0, 0.12, (40, 40)).astype(np.float32)
    sd = _snap_noise_bins(sd, cfg)
    np.testing.assert_array_equal(_noise_hist(sd, cfg).astype(np.int64),
                                  golden.noise_histogram(sd, cfg))


def test_grad_hist_matches_golden():
    rng = np.random.default_rng(73)
    cfg = MusicaConfig(image_size=256)
    n = 256
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(np.float32)
    recon[rng.uniform(size=(n, n)) < 0.02] = 0.0
    recon = _snap_grad_bins(recon, cfg)
    relevant = _snap_weights((rng.uniform(0, 1, (n, n)) ** 2).astype(np.float32))
    g = golden.gradation_histogram(recon, relevant, cfg)
    j = np.asarray(jax.jit(lambda r, w: gradation.gradation_histogram(
        r, w, cfg))(jnp.asarray(recon), jnp.asarray(relevant)))
    np.testing.assert_array_equal(j.astype(np.int64), g)


def test_grad_hist_with_pipeline_relevance_matches_golden():
    """The pipeline's wiring: relevance from img_relevant feeds the
    gradation histogram inside one jitted program; the counts equal the
    golden histogram of that same relevance image."""
    rng = np.random.default_rng(74)
    cfg = MusicaConfig(image_size=512)
    n = 512
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(np.float32)
    recon[rng.uniform(size=(n, n)) < 0.02] = 0.0
    recon = _snap_grad_bins(recon, cfg)
    normalized = rng.uniform(0, 1.01, (n, n)).astype(np.float32)
    cnr = rng.uniform(0, 0.1, (64, 64)).astype(np.float32)

    @jax.jit
    def both(r, nrm, c):
        rel = noise.img_relevant(nrm, c, cfg)
        return rel, gradation.gradation_histogram(r, rel, cfg)

    args = (jnp.asarray(normalized), jnp.asarray(cnr))
    rel = np.asarray(both(jnp.asarray(recon), *args)[0])
    # uint(rel * 100) on a knife edge may truncate either way across
    # compilers: push those pixels out of range (a dropped entry, not a
    # tile abort) so every remaining count is compared exactly
    t = rel * F32(100.0)
    knife = (np.abs(t - np.round(t)) < 1e-3) & (t != np.round(t))
    assert knife.mean() < 0.05
    recon = np.where(knife, F32(1.5), recon).astype(F32)
    rel2, h = both(jnp.asarray(recon), *args)
    np.testing.assert_array_equal(np.asarray(rel2), rel)
    h = np.asarray(h).astype(np.int64)
    np.testing.assert_array_equal(h, golden.gradation_histogram(recon, rel, cfg))
    assert h.sum() > 0


def test_analysis_noise_hists_match_golden():
    """Noise histogram + first-max argmax for every analysis level at once,
    over ragged level sizes (1024/512/256/128) and an all-zero level
    (histogram all zero -> bin 0)."""
    rng = np.random.default_rng(77)
    cfg = MusicaConfig(image_size=1024)  # analysis levels 0..3
    sdevs = {}
    for i in cfg.analysis_levels:
        n = 1024 >> i
        sd = rng.uniform(0, 0.12, (n, n)).astype(np.float32)
        sd[rng.uniform(size=(n, n)) < 0.08] = 0.0
        if i == 3:
            sd[:] = 0.0  # empty level: argmax must be bin 0
        sdevs[i] = _snap_noise_bins(sd, cfg)
    hists, maxb = jax.jit(lambda s: stats.analysis_noise_hists(s, cfg))(
        {i: jnp.asarray(v) for i, v in sdevs.items()})
    for i in cfg.analysis_levels:
        ref = golden.noise_histogram(sdevs[i], cfg)
        np.testing.assert_array_equal(np.asarray(hists[i]).astype(np.int64),
                                      ref, err_msg=f"level {i}")
        assert int(maxb[i]) == golden.histogram_max(ref)[1], f"level {i}"
    assert int(maxb[3]) == 0


def test_analysis_argmax_first_max_tie():
    """Duplicate maximum counts: the argmax keeps the FIRST bin
    (img_histogram_max.comp uses strict >)."""
    cfg = MusicaConfig(image_size=512)  # 256 would scan nothing (coverage 0)
    # two discrete sdev values mapping to two different bins, equal counts
    v1, v2 = np.float32(0.0301), np.float32(0.0703)
    sd0 = np.zeros((512, 512), np.float32)
    sd0[0, :16] = v1   # one full tile-column group each, no breaks
    sd0[0, 16:32] = v2
    sdevs = {i: jnp.asarray(np.zeros((512 >> i, 512 >> i), np.float32))
             for i in cfg.analysis_levels}
    sdevs[0] = jnp.asarray(sd0)
    hists, maxb = stats.analysis_noise_hists(sdevs, cfg)
    h0 = np.asarray(hists[0])
    top = np.flatnonzero(h0 == h0.max())
    assert len(top) == 2 and h0.max() == 16  # a genuine tie
    assert int(maxb[0]) == top[0]


def test_pipeline_noise_max_bins_match_golden():
    """End-to-end wiring: the argmax bins of every analysis level inside
    musica_forward equal the golden full pass's (docs/PARITY.md)."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph
    img = synthetic_radiograph(512, "hand")
    cfg = MusicaConfig(image_size=512)
    res = jax.jit(lambda a: musica.musica_forward(
        a, cfg, want_intermediates=True)["intermediates"])(jnp.asarray(img))
    _, g = golden.process(img, cfg, return_intermediates=True)
    for i in cfg.analysis_levels:
        assert int(res[f"noise_max_bin_{i}"]) == g["noise_max_bins"][i], i
    assert int(np.asarray(res["noise_hist_0"]).sum()) > 0


def test_noise_hist_nonfactorizable_bins():
    """A bin count that does not split into 32-aligned factors (2000 ->
    padded 2016) must still give the exact golden counts and argmaxes."""
    rng = np.random.default_rng(5)
    cfg = MusicaConfig(image_size=512, noise_histogram_bins=2000)
    assert stats._factor(cfg.noise_histogram_bins)[2] != cfg.noise_histogram_bins
    sdevs = {}
    for i in cfg.analysis_levels:
        n = 512 >> i
        sd = rng.uniform(0, 0.12, (n, n)).astype(np.float32)
        sdevs[i] = _snap_noise_bins(sd, cfg)
    hists, maxb = stats.analysis_noise_hists(
        {i: jnp.asarray(v) for i, v in sdevs.items()}, cfg)
    for i in cfg.analysis_levels:
        ref = golden.noise_histogram(sdevs[i], cfg)
        np.testing.assert_array_equal(np.asarray(hists[i]).astype(np.int64),
                                      ref, err_msg=f"level {i}")
        assert int(maxb[i]) == golden.histogram_max(ref)[1], f"level {i}"
