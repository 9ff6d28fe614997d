"""Config-space parity fuzz: the jit pipeline must track the golden oracle
for valid NON-DEFAULT configurations, not just the reference presets.

Motivated by an earlier finding that a platform-specific histogram
dispatch crashed for noise_histogram_bins not factorizable by its
kernel (fixed with a fallback): robustness regressions for legal configs
hide exactly where no test ever instantiates them.  Each case below varies
a different axis (ragged pyramid structure, non-factorizable histogram
bins, variant combinations, schedule knobs, clean-math mode) and checks
jit-vs-golden agreement at the same thresholds as the preset parity tests
(PSNR > 55 dB, > 98% bit-equal u8)."""

import numpy as np
import pytest

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import (
    MusicaConfig,
)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import (
    golden,
    musica,
)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import (
    synthetic_radiograph,
)


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = (d * d).mean()
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# relevant_border is shrunk for sizes < 256: the reference's 100-px border
# exclusion would otherwise blank the relevance mask entirely on small
# test images (on 3072 inputs the default is live).
CASES = [
    # non-factorizable histogram bins (the advisor regression class) +
    # a non-power-of-two-adjacent size
    dict(image_size=160, noise_histogram_bins=2000, grad_histogram_bins=1000,
         relevant_border=12),
    # ragged pyramid (96/48/24/12/6/3/2) + both LINEAR_* contrast variants
    dict(image_size=96, linear_low_contrast=True, linear_high_contrast=True,
         relevant_border=8),
    # odd ladder (100/50/25/13/7/4/2) + shifted analysis structure
    dict(image_size=100, coarser_levels_start=2, cnr_level=2,
         relevant_border=8),
    # both compile-time variants together (CLAHE grades recon, gradation
    # grades the squared recon)
    dict(image_size=144, enable_clahe=True, grad_with_linear_image=True,
         relevant_border=10),
    # clean-math mode with reduced bins
    dict(image_size=128, quirks=False, noise_histogram_bins=512,
         relevant_border=10),
    # schedule knobs off the reference values
    dict(image_size=192, nr_high_cnr=6.0, nr_min_low_factor=0.5,
         grad_slope=2.0, grad_y_mid=0.4, relevant_border=14),
    # tiny image, tiny non-factorizable bins
    dict(image_size=64, noise_histogram_bins=96, grad_histogram_bins=100,
         relevant_border=5),
    # histogram coverage quirk live at small size (120 // 64 * 64 = 64)
    dict(image_size=120, hist_workgroup_coverage=64, relevant_border=9),
]


@pytest.mark.parametrize("kw", CASES,
                         ids=[f"case{i}" for i in range(len(CASES))])
def test_nondefault_config_matches_golden(kw):
    cfg = MusicaConfig(**kw)
    img = synthetic_radiograph(cfg.image_size, "pelvis")

    # one jitted whole-pipeline program (what production runs -- eager
    # per-op dispatch would miss whole-program fusion/contraction effects);
    # only the compared outputs are returned so XLA DCEs the rest
    import jax

    want = ("out_u8", "clahe_graded") if cfg.enable_clahe else ("out_u8",)
    fwd = jax.jit(lambda im: {k: musica.musica_forward(im, cfg)[k]
                              for k in want})
    res = jax.device_get(fwd(img))
    j_out = np.asarray(res["out_u8"])

    g_out, g_inter = golden.process(img, cfg, return_intermediates=True)

    m = cfg.out_margin
    assert j_out.shape == (cfg.image_size - 2 * m,) * 2
    assert j_out.shape == g_out.shape
    assert _psnr(j_out, g_out) > 55.0, kw
    assert np.mean(j_out == g_out) > 0.98, kw

    if "clahe_graded" in want:
        np.testing.assert_allclose(
            np.asarray(res["clahe_graded"]), g_inter["clahe_graded"],
            rtol=0, atol=1e-5)
