"""Debug/observability surface: intermediate dumps, histogram renders,
stage timer, CLI process with --debug-dump."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import debug, io as uio


def test_dump_intermediates(tmp_path, phantom_256):
    cfg = MusicaConfig(image_size=256)
    res = jax.jit(lambda im: musica.musica_forward(im, cfg, want_intermediates=True)
                  )(jnp.asarray(phantom_256))
    inter = {k: (v if isinstance(v, tuple) else np.asarray(v))
             for k, v in res["intermediates"].items()}
    debug.dump_intermediates(inter, str(tmp_path))
    names = {p.name for p in tmp_path.iterdir()}
    # mirror of debugProcess's dump surface
    assert "normalized.bmp" in names
    assert "red_bandpass_0.bmp" in names
    assert "relevant.bmp" in names
    assert "grad_hist.bmp" in names
    assert "noise_hist.bmp" in names
    img = uio.load_bmp(tmp_path / "normalized.bmp")
    assert img.shape == (256, 256)


def test_render_histogram_shapes(rng):
    h = rng.integers(0, 1000, 1024)
    img = debug.render_histogram(h, curve=(np.linspace(0, 1, 22),
                                           np.linspace(0, 1, 22)),
                                 markers=[0.2, 0.5, 0.8])
    assert img.shape == (128, 512, 3)
    assert img.dtype == np.uint8
    # baseline drawn (curve/markers may overwrite individual pixels)
    assert (img[-1, :, 0] == 255).mean() > 0.9


def test_stage_timer(phantom_256):
    cfg = MusicaConfig(image_size=256)
    t = debug.StageTimer()
    out = musica.process_jit(jnp.asarray(phantom_256), cfg)
    t.mark("process", out)
    s = t.summary()
    assert "process" in s and "tot" in s


def test_cli_process_with_debug_dump(tmp_path, phantom_256):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, phantom_256)
    out = tmp_path / "out.bmp"
    rc = cli.main(["process", "--size", "256", str(raw), str(out),
                   "--debug-dump", str(tmp_path / "dbg")])
    assert rc == 0
    assert out.exists()
    assert (tmp_path / "dbg" / "normalized.bmp").exists()
    img = uio.load_bmp(out)
    assert img.shape == (236, 236)


def test_cli_batch(tmp_path, phantom_256):
    """The chunked lax.map batch path (incl. zero-padding the last partial
    chunk to the compiled B) must write exactly what `process` writes."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli
    for i in range(2):
        uio.save_raw(tmp_path / f"img_{i}.raw", phantom_256)
    rc = cli.main(["batch", "--size", "256", str(tmp_path / "*.raw"),
                   str(tmp_path / "out")])
    assert rc == 0
    assert (tmp_path / "out" / "img_0.bmp").exists()
    assert (tmp_path / "out" / "img_1.bmp").exists()
    rc = cli.main(["process", "--size", "256", str(tmp_path / "img_0.raw"),
                   str(tmp_path / "single_0.bmp")])
    assert rc == 0
    import numpy as np
    np.testing.assert_array_equal(uio.load_bmp(tmp_path / "out" / "img_0.bmp"),
                                  uio.load_bmp(tmp_path / "single_0.bmp"))


def test_cli_timing_and_variants(tmp_path, phantom_256):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, phantom_256)
    out = tmp_path / "out.bmp"
    rc = cli.main(["process", "--size", "256", str(raw), str(out),
                   "--timing", "--save-last-raw", str(tmp_path / "last.raw"),
                   "--linear-gradation"])
    assert rc == 0
    assert out.exists()
    assert (tmp_path / "last.raw").exists()
    back = uio.load_raw(tmp_path / "last.raw", 256, transpose=False)
    np.testing.assert_array_equal(back, phantom_256.T)  # CLI loads transposed


def test_cli_process_profile_trace(tmp_path, phantom_256):
    """--profile captures an XPlane trace dir (the /PROFILE analogue) while
    producing the identical output image."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, phantom_256)
    out = tmp_path / "out.bmp"
    ref = tmp_path / "ref.bmp"
    prof = tmp_path / "prof"
    rc = cli.main(["process", "--size", "256", str(raw), str(out),
                   "--profile", str(prof)])
    assert rc == 0
    # the profiler writes plugins/profile/<ts>/*.xplane.pb under the dir
    traces = list(prof.rglob("*.xplane.pb"))
    assert traces, f"no xplane trace written under {prof}"
    rc = cli.main(["process", "--size", "256", str(raw), str(ref)])
    assert rc == 0
    np.testing.assert_array_equal(uio.load_bmp(out), uio.load_bmp(ref))


def test_linear_gradation_variant_changes_output(phantom_256):
    cfg_a = MusicaConfig(image_size=256)
    cfg_b = MusicaConfig(image_size=256, grad_with_linear_image=True)
    a = musica.process(phantom_256, cfg_a)
    b = musica.process(phantom_256, cfg_b)
    assert a.shape == b.shape
    assert not np.array_equal(a, b)


def test_cli_report(tmp_path, phantom_256):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, phantom_256)
    rc = cli.main(["report", "--size", "256", str(raw),
                   str(tmp_path / "rep")])
    assert rc == 0
    idx = tmp_path / "rep" / "index.html"
    assert idx.exists()
    text = idx.read_text()
    assert "out.bmp" in text and "grad_hist" in text
    assert (tmp_path / "rep" / "out.bmp").exists()
    assert (tmp_path / "rep" / "cnr.bmp").exists()


def test_cli_cnr_out_feeds_mean_cnr(tmp_path, phantom_256):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import analysis
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, phantom_256)
    cnr_dir = tmp_path / "cnr"
    cnr_dir.mkdir()
    rc = cli.main(["process", "--size", "256", str(raw),
                   str(tmp_path / "out.bmp"),
                   "--cnr-out", str(cnr_dir / "case.bmp")])
    assert rc == 0
    res = analysis.mean_cnr_dir(str(cnr_dir))
    assert len(res) == 1
    assert 0.0 <= res[0][1] <= 256.0


def test_contrast_curve_render_in_dump(tmp_path, phantom_256):
    import jax, jax.numpy as jnp
    cfg = MusicaConfig(image_size=256)
    res = jax.jit(lambda im: musica.musica_forward(im, cfg, want_intermediates=True)
                  )(jnp.asarray(phantom_256))
    inter = {k: (v if isinstance(v, tuple) else np.asarray(v))
             for k, v in res["intermediates"].items()}
    inter["contrast_curve_0"] = tuple(np.asarray(v) for v in inter["contrast_curve_0"])
    debug.dump_intermediates(inter, str(tmp_path))
    assert (tmp_path / "contrast_curve_0.bmp").exists()
