"""Metamorphic harness tests: metrics, perturbations, campaign, analysis."""

import csv
import numpy as np
import pytest

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import (
    analysis, campaign, metrics, perturb,
)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------

def test_mse_similarity_identity_and_scale(rng):
    a = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    assert metrics.mse_similarity(a, a) == 1.0
    b = np.clip(a.astype(int) + 51, 0, 255).astype(np.uint8)  # shift ~0.2*255
    s = metrics.mse_similarity(a, b)
    assert 0.75 < s < 0.85


def test_ssim_basics(rng):
    a = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    assert abs(metrics.ssim_similarity(a, a) - 1.0) < 1e-12
    noisy = np.clip(a.astype(int) + rng.normal(0, 40, a.shape), 0, 255).astype(np.uint8)
    s = metrics.ssim_similarity(a, noisy)
    assert 0.0 < s < 0.9


def test_ssim_matches_reference_formula():
    # constant images: SSIM must be exactly 1
    a = np.full((32, 32), 100, np.uint8)
    assert abs(metrics.ssim_similarity(a, a) - 1.0) < 1e-12
    # constant vs shifted constant: luminance term only
    b = np.full((32, 32), 110, np.uint8)
    c1 = (0.01 * 255) ** 2
    expected = (2 * 100 * 110 + c1) / (100 ** 2 + 110 ** 2 + c1)
    assert abs(metrics.ssim_similarity(a, b) - expected) < 1e-9


def test_ssim_jax_matches_numpy_oracle(rng):
    """The device (f32) SSIM used by the campaign on a GPU must track the f64
    NumPy oracle to ~1e-5 -- on random, structured, and odd-shaped pairs."""
    a = rng.integers(0, 256, (301, 211)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 20, a.shape), 0, 255
                ).astype(np.uint8)
    ref = metrics.ssim_similarity(a, b, method="numpy")
    got = metrics.ssim_similarity(a, b, method="jax")
    assert abs(ref - got) < 1e-5
    # structured gradient pair
    g = (np.linspace(0, 255, 300)[:, None]
         * np.ones((1, 300))).astype(np.uint8)
    h = np.clip(g.astype(int) + rng.integers(-5, 5, g.shape), 0, 255
                ).astype(np.uint8)
    assert abs(metrics.ssim_similarity(g, h, method="numpy")
               - metrics.ssim_similarity(g, h, method="jax")) < 1e-5
    # identity
    assert abs(metrics.ssim_similarity(a, a, method="jax") - 1.0) < 1e-6


def test_measure_row_device_matches_host_oracles(rng):
    """The fused one-call device metric program (mse+ssim+hist-euclid x2)
    must track the f64 host oracles; exercised on CPU-jax here, used on the
    GPU by the campaign."""
    import jax.numpy as jnp
    alt = rng.integers(0, 256, (173, 211)).astype(np.uint8)
    unalt = np.clip(alt.astype(int) + rng.integers(-25, 25, alt.shape),
                    0, 255).astype(np.uint8)
    ref = np.clip(alt.astype(int) + rng.integers(-5, 5, alt.shape),
                  0, 255).astype(np.uint8)
    vals = metrics.measure_row_device(alt, jnp.asarray(unalt),
                                      jnp.asarray(ref))
    expected = [
        metrics.mse_similarity(alt, unalt),
        metrics.ssim_similarity(alt, unalt, method="numpy"),
        metrics.hist_similarity(alt, unalt)[1],
        metrics.mse_similarity(alt, ref),
        metrics.ssim_similarity(alt, ref, method="numpy"),
        metrics.hist_similarity(alt, ref)[1],
    ]
    np.testing.assert_allclose(vals, expected, rtol=0, atol=2e-5)
    # identity row: mse/ssim exactly 1, hist distance exactly 0
    v_id = metrics.measure_row_device(alt, jnp.asarray(alt), jnp.asarray(alt))
    np.testing.assert_allclose(v_id, [1, 1, 0, 1, 1, 0], rtol=0, atol=1e-6)


def test_campaign_device_metric_path_matches_host(tmp_path, monkeypatch):
    """run_campaign with the device metric path forced on (CPU-jax) must
    reproduce the host-path CSV numbers to ~1e-4."""
    res_host = campaign.run_campaign(
        out_dir=str(tmp_path / "host"), image_size=256,
        anatomies=["knee"], seed=3)
    monkeypatch.setattr(metrics, "device_metrics_available", lambda: True)
    res_dev = campaign.run_campaign(
        out_dir=str(tmp_path / "dev"), image_size=256,
        anatomies=["knee"], seed=3)
    for csv_name in (campaign.R_CSV, campaign.NR_CSV, campaign.S_CSV):
        for rh, rd in zip(res_host[csv_name][1:], res_dev[csv_name][1:]):
            assert rh[:2] == rd[:2]
            np.testing.assert_allclose(
                [float(v) for v in rh[2:]], [float(v) for v in rd[2:]],
                rtol=0, atol=2e-4, err_msg=f"{csv_name} {rh[:2]}")


def test_hist_similarity(rng):
    a = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    inter, e, bc = metrics.hist_similarity(a, a)
    assert inter == 1.0 and e == 0.0 and abs(bc - 1.0) < 1e-9
    b = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    _, e2, _ = metrics.hist_similarity(a, b)
    assert e2 > 0.0


# ----------------------------------------------------------------------
# perturbations
# ----------------------------------------------------------------------

def test_quantum_noise_statistics(rng):
    img = np.full((256, 256), 10000, np.uint16)
    noisy = perturb.apply_quantum_noise(img, 0.1, rng)
    # Poisson(1000)/0.1: mean ~10000, std ~ sqrt(1000)/0.1 ~ 316
    assert abs(float(noisy.mean()) - 10000) < 50
    assert 250 < float(noisy.std()) < 400


def test_gaussian_noise_statistics(rng):
    img = np.full((256, 256), 30000, np.uint16)
    noisy = perturb.add_gaussian_noise(img, 0.0, 256.0, rng)
    assert abs(float(noisy.mean()) - 30000) < 30
    assert 200 < float(noisy.std()) < 320


def test_collimator_masks_border(rng):
    img = np.full((512, 512), 40000, np.uint16)
    out = perturb.apply_collimator(img, 100, 100, rng)
    assert out[256, 256] == 40000                  # window untouched
    assert out[50, 50] < 2000                      # outside: ~dose/100
    assert out[50, 256] < 2000


def test_translation_fill_and_shift():
    img = np.arange(512 * 512, dtype=np.uint16).reshape(512, 512)
    out = perturb.clamp_translation(img, x_shift=100)
    # the reference crops a margin-10 strip first, then pastes at x_shift:
    # out[y, x_shift + (x - 10)] == img[y, x]
    assert out[256, 200] == img[256, 110]
    # fill on the vacated side
    assert (out[:, :90] == out[0, 0]).all()


def test_rotation_shape_and_fill():
    img = synthetic_radiograph(512, "hand")
    out = perturb.clamp_rotate(img, 45)
    assert out.shape == img.shape
    assert out.dtype == np.uint16


@pytest.mark.parametrize("size", [300, 1024])
@pytest.mark.parametrize("degree", perturb.ROTATIONS)
def test_rotate_nearest_matches_pil(size, degree):
    """The NumPy port of PIL's NEAREST rotate is bit-exact against PIL for
    both image kinds the campaign rotates: the uint16 input raw (mode
    "I;16", with a fill value, as clamp_rotate calls it) and the uint8
    outputs (mode "L", default zero fill, as the registration step)."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(size + degree)
    img16 = rng.integers(0, 65536, (size, size)).astype(np.uint16)
    ref16 = np.array(Image.fromarray(img16).rotate(degree, fillcolor=4321),
                     dtype=np.uint16)
    np.testing.assert_array_equal(perturb.rotate_nearest(img16, degree, 4321),
                                  ref16)
    img8 = rng.integers(0, 256, (size, size)).astype(np.uint8)
    np.testing.assert_array_equal(perturb.rotate_nearest(img8, degree),
                                  np.array(Image.fromarray(img8).rotate(degree)))


# ----------------------------------------------------------------------
# campaign + analysis
# ----------------------------------------------------------------------

def test_campaign_smoke(tmp_path):
    res = campaign.run_campaign(
        out_dir=str(tmp_path), image_size=256, anatomies=["knee"], seed=3)
    rows = res[campaign.R_CSV]
    assert rows[0][0] == "raw file"
    # 5 steps x 6 families = 30 direct cases
    assert len(rows) - 1 == 30
    # all similarity values must be finite and within sane ranges
    for r in rows[1:]:
        own_mse = float(r[2])
        assert 0.0 <= own_mse <= 1.0
    assert (tmp_path / campaign.R_CSV).exists()
    assert (tmp_path / campaign.NR_CSV).exists()
    assert (tmp_path / campaign.S_CSV).exists()
    # robustness: weak perturbations stay close to the unaltered output
    by_name = {r[1]: float(r[2]) for r in rows[1:]}
    assert by_name["gn_4.0"] > 0.9


def test_campaign_input_dir_with_dicom_reference(tmp_path, monkeypatch, rng):
    """The real-data campaign entry (script.py:374-405 semantics): raws read
    from <input_dir>/<anatomy>/image.raw and the vendor 'proc' DICOM used as
    ground truth (16->8-bit + invert, margin-cropped) -- the ovd row must
    measure against the DICOM-derived reference, not the trivial
    self-reference."""
    import sys
    import types
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as uio

    size = 256
    anat = "knee"
    d = tmp_path / "in" / anat
    d.mkdir(parents=True)
    uio.save_raw(d / "image.raw", synthetic_radiograph(size, anat))
    ref16 = rng.integers(0, 65536, (size, size)).astype(np.uint16)
    (d / "proc").write_bytes(ref16.tobytes())

    stub = types.ModuleType("pydicom")
    stub.dcmread = lambda p: types.SimpleNamespace(
        pixel_array=np.frombuffer(open(p, "rb").read(),
                                  np.uint16).reshape(size, size))
    monkeypatch.setitem(sys.modules, "pydicom", stub)

    res = campaign.run_campaign(out_dir=str(tmp_path / "out"),
                                image_size=size, anatomies=[anat],
                                input_dir=str(tmp_path / "in"))
    row = res[campaign.S_CSV][1]
    assert row[0] == anat
    # vs a random DICOM reference the similarities are far from identity
    assert float(row[1]) < 0.999 and float(row[2]) < 0.999
    # and the direct rows' normalized columns divide by that ovd
    r = res[campaign.R_CSV][1]
    np.testing.assert_allclose(float(r[8]),
                               float(r[5]) / float(row[1]), rtol=1e-9)


def test_slope_analysis_flags_trends():
    header = ["Alteration", "delta mse"]
    rows = [header]
    # family 1: strong trend; family 2: flat
    for i, v in enumerate([0.0, 0.1, 0.2, 0.3, 0.4]):
        rows.append([f"a_{i}", str(v)])
    for i, v in enumerate([0.5, 0.5, 0.5, 0.5, 0.5]):
        rows.append([f"b_{i}", str(v)])
    out = analysis.slope_analysis(rows)
    assert len(out) == 2
    (m1, _, s1, f1), (m2, _, s2, f2) = out
    assert f1 and abs(s1 - 0.1) < 1e-12
    assert not f2 and abs(s2) < 1e-12


def test_slope_analysis_reads_semicolon_csv(tmp_path):
    p = tmp_path / "results.csv"
    p.write_text("Alteration;delta mse\n" +
                 "".join(f"x_{i};{i * 0.05}\n" for i in range(5)))
    lines = analysis.slope_analysis_file(str(p), out_file=str(tmp_path / "out.txt"))
    assert len(lines) == 1 and "slope test=True" in lines[0]
    assert (tmp_path / "out.txt").exists()


def test_mean_cnr(tmp_path):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils.io import save_bmp8
    save_bmp8(tmp_path / "a.bmp", np.full((16, 16), 128, np.uint8))
    res = analysis.mean_cnr_dir(str(tmp_path), out_file=str(tmp_path / "out.txt"))
    assert len(res) == 1
    assert abs(res[0][1] - 128.0) < 1e-9  # (128/256)*256


def test_campaign_to_slope_analysis_end_to_end(tmp_path):
    """Campaign -> deltas.csv (results.csv format) -> slope criterion,
    the reference's full statistical post-analysis loop."""
    campaign.run_campaign(out_dir=str(tmp_path), image_size=256,
                          anatomies=["foot"], seed=7)
    assert (tmp_path / "deltas.csv").exists()
    lines = analysis.slope_analysis_file(str(tmp_path / "deltas.csv"),
                                         out_file=str(tmp_path / "out.txt"))
    # 6 families x 9 metrics = 54 slope rows
    assert len(lines) == 54
    assert (tmp_path / "out.txt").exists()
    # noise MRs should show a robustness trend (growing delta with intensity)
    flagged = [ln for ln in lines if "slope test=True" in ln]
    assert len(flagged) >= 1


def test_build_delta_table_shape():
    rows = [campaign._ROBUSTNESS_HEADER,
            ["a", "x_1", *([0.9] * 9)],
            ["b", "x_1", *([0.7] * 9)],
            ["a", "x_2", *([0.5] * 9)]]
    table = analysis.build_delta_table(rows)
    assert table[0][0] == "Alteration"
    assert len(table) == 3  # header + x_1 + x_2
    # x_1 averaged over anatomies: 1 - 0.8 = 0.2 for similarity columns
    assert abs(table[1][1] - 0.2) < 1e-12
    # histogram-distance columns: -value
    assert abs(table[1][3] + 0.8) < 1e-12
