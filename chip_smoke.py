"""Smoke run of the MUSICA pipeline on one GPU at the reference's production
size (3072^2), through the entry points a user calls.

    python chip_smoke.py                 # phases 1-6 on one card
    python chip_smoke.py --four-cards    # phase 7 only, on four cards

Phases (each one failing the run with a non-zero exit):
  1. the first JAX device must be a GPU;
  2. build the native raw/BMP codec from source (``make -C native``);
  3. ``cli process`` on seeded 3072^2 raws and ``cli batch`` over four of
     them, whose outputs must equal the single-image ones byte for byte;
  4. parity with the NumPy golden model (models/golden.py): u8 PSNR >= 50 dB,
     noise-histogram argmax bins and gradation t0/ta/t1 equal; the same for
     the CLAHE + linear-gradation variant (CLAHE criteria of
     docs/PARITY.md) at ``CLAHE_SIZE``; the bf16 storage mode vs f32
     under the contract of tests/test_bf16.py;
  5. the histogram on the card, on the real 3072 level images, gives counts
     equal to ``np.bincount`` on the host;
  6. ``cli campaign`` at 3072 for one anatomy writes its four CSVs;
  7. (``--four-cards``) ``sharding.process_sharded`` on data=4 and on
     data=2 x space=2, compared with single-device outputs.

The golden model runs on the host in worker processes that never import
JAX, started first so that they overlap the device phases; the card is
used by this one process only.  The last line of standard output is one
JSON object with the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "smoke_work"  # raws and outputs of phases 3 and 6
SIZE = 3072
# the golden CLAHE apply (16 full-image getY walks over a 256-point LUT) is
# too slow on the host for 3072 inside the run's time budget
CLAHE_SIZE = 2048
# raws of the batch phase, each with its anatomy's own phantom seed (seed 0
# at 512 px hits the gradation fit's metastability, docs/QUIRKS.md #31)
ANATOMIES = ("thorax", "hand", "knee", "pelvis")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def golden_job(size: int, anatomy: str, variant: dict) -> dict:
    """Host-only golden pass (run in a worker process; imports no JAX)."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph

    t0 = time.perf_counter()
    img = synthetic_radiograph(size, anatomy)
    cfg = MusicaConfig(image_size=size, **variant)
    out, inter = golden.process(img, cfg, return_intermediates=True)
    res = {"out_u8": out,
           "max_bins": {i: int(v) for i, v in inter["noise_max_bins"].items()},
           "tvals": [float(np.float32(t)) for t in inter["grad_curve"][2]],
           "seconds": time.perf_counter() - t0}
    if cfg.enable_clahe:
        res["clahe_graded"] = inter["clahe_graded"]
    return res


def device_outputs(img: np.ndarray, cfg):
    """out_u8, argmax bins, t0/ta/t1 (and clahe_graded) of one jitted
    forward pass on the card."""
    import jax
    import jax.numpy as jnp

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica

    def fwd(im):
        r = musica.musica_forward(im, cfg, want_intermediates=True)
        inter = r["intermediates"]
        out = {"out_u8": r["out_u8"], "tvals": jnp.stack(inter["grad_curve"][2]),
               "max_bins": {i: inter[f"noise_max_bin_{i}"]
                            for i in cfg.analysis_levels}}
        if cfg.enable_clahe:
            out["clahe_graded"] = r["clahe_graded"]
        return out

    return jax.device_get(jax.jit(fwd)(jnp.asarray(img)))


def compare_with_golden(name: str, dev: dict, gold: dict) -> None:
    d = dev["out_u8"].astype(np.int32) - gold["out_u8"].astype(np.int32)
    p = psnr_u8(dev["out_u8"], gold["out_u8"])
    log(f"  {name}: PSNR {p:.2f} dB, bit-exact {float((d == 0).mean()):.6%}, "
        f"max|du8| {int(np.abs(d).max())} (golden {gold['seconds']:.1f} s on "
        "the host)")
    check(p >= 50.0, f"{name}: PSNR {p:.2f} dB < 50")
    bins = {i: int(v) for i, v in dev["max_bins"].items()}
    log(f"  {name}: argmax bins {bins} vs golden {gold['max_bins']}")
    check(bins == gold["max_bins"], f"{name}: noise argmax bins differ")
    tv = [float(np.float32(t)) for t in dev["tvals"]]
    log(f"  {name}: t0/ta/t1 {tv} vs golden {gold['tvals']}")
    check(tv == gold["tvals"], f"{name}: gradation t0/ta/t1 differ")


def run_cli(argv) -> None:
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli

    rc = cli.main([str(a) for a in argv])
    check(rc == 0, f"cli {argv[0]} returned {rc}")


def phase_cli(size: int, work: Path) -> None:
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as uio

    raws = []
    for k, anat in enumerate(ANATOMIES):
        p = work / "raws" / f"{k}_{anat}.raw"
        uio.save_raw(p, synthetic_radiograph(size, anat))
        raws.append(p)
    singles = []
    for k, p in enumerate(raws):
        out = work / "single" / f"{p.stem}.bmp"
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        run_cli(["process", "--size", size, p, out])
        log(f"  cli process {p.name}: {time.perf_counter() - t0:.2f} s"
            + (" (includes compile)" if k == 0 else ""))
        singles.append(out)
    t0 = time.perf_counter()
    run_cli(["batch", "--size", size, "--batch", len(raws),
             work / "raws" / "*.raw", work / "batch"])
    log(f"  cli batch of {len(raws)}: {time.perf_counter() - t0:.2f} s "
        "(includes compile)")
    for s in singles:
        b = work / "batch" / s.name
        check(b.read_bytes() == s.read_bytes(),
              f"batch output {b.name} differs from the single-image output")
    log(f"  batch outputs equal the {len(singles)} single-image outputs")


def phase_hist_exact(img: np.ndarray, cfg) -> None:
    """The histogram on the card vs np.bincount on the host, on the real
    level images (noise levels and the gradation histogram)."""
    import jax
    import jax.numpy as jnp

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import gradation, noise, stats

    @jax.jit
    def level_bins(im):
        r = musica.musica_forward(im, cfg, want_intermediates=True)
        inter = r["intermediates"]
        out = {f"noise{i}": stats.noise_bins(inter[f"sdev_{i}"], cfg)
               for i in cfg.analysis_levels}
        rel = noise.img_relevant(inter["normalized"], r["cnr"], cfg)
        out["grad"] = gradation.gradation_bins(r["recon"], rel, cfg)
        return out

    hist = jax.jit(stats.fixed_histogram, static_argnums=2)
    for name, (b, w) in level_bins(jnp.asarray(img)).items():
        n_bins = (cfg.grad_histogram_bins if name == "grad"
                  else cfg.noise_histogram_bins)
        h = np.asarray(hist(b, w, n_bins))
        bn, wn = np.asarray(b).reshape(-1), np.asarray(w).reshape(-1)
        keep = (bn >= 0) & (bn < n_bins) & (wn > 0)
        ref = np.bincount(bn[keep], weights=wn[keep].astype(np.int64),
                          minlength=n_bins).astype(np.int64)
        check(np.array_equal(h.astype(np.int64), ref),
              f"{name} histogram != np.bincount")
        log(f"  {name}: {bn.size} entries, total count {int(ref.sum())}, "
            "equal to np.bincount")


def phase_bf16(img: np.ndarray, cfg, out32: np.ndarray) -> None:
    """bf16 storage vs the f32 parity mode (tests/test_bf16.py contract for
    sizes >= 512)."""
    import jax.numpy as jnp

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica

    o16 = np.asarray(musica.process_jit(
        jnp.asarray(img), cfg.with_(storage="bfloat16"))).astype(np.int32)
    d = np.abs(out32.astype(np.int32) - o16)
    knife = d > 32
    inlier = d[~knife].astype(np.float64)
    mse = float((inlier ** 2).mean())
    p = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    log(f"  bf16 vs f32: knife share {float(knife.mean()):.2e}, inlier "
        f"max {int(inlier.max())}, inlier PSNR {p:.2f} dB, identical "
        f"{float((d == 0).mean()):.4%}")
    check(float(knife.mean()) <= 3e-4, "bf16: too many knife-edge pixels")
    check(inlier.max() <= 16, "bf16: inlier difference above 16 LSB")
    check(p >= 38.0, "bf16: inlier PSNR below 38 dB")


def phase_clahe(dev: dict, gold: dict) -> None:
    """docs/PARITY.md CLAHE criteria: equal NaN masks (empty tiles), the
    finite values within a knife-edge tail of rare bin flips."""
    a, g = dev["clahe_graded"], gold["clahe_graded"]
    an, gn = np.isnan(a), np.isnan(g)
    cd = np.abs(np.where(an | gn, 0.0, a - g))
    n = cd.size
    log(f"  clahe_graded: NaN masks equal {bool(np.array_equal(an, gn))}, "
        f"max|d| {float(cd.max()):.3g}, px > 1e-2: {int((cd > 1e-2).sum())}"
        f", px > 1e-1: {int((cd > 1e-1).sum())} of {n}")
    check(np.array_equal(an, gn), "clahe_graded NaN masks differ")
    check((cd > 1e-2).sum() <= 1e-4 * n, "clahe_graded tail above 1e-4")


def phase_campaign(size: int, work: Path) -> None:
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import campaign

    out = work / "campaign"
    t0 = time.perf_counter()
    run_cli(["campaign", "--size", size, "--anatomies", "thorax",
             "--out-dir", out])
    dt = time.perf_counter() - t0
    rows = {}
    for name in (campaign.R_CSV, campaign.NR_CSV, campaign.S_CSV,
                 "deltas.csv"):
        p = out / name
        check(p.exists() and p.stat().st_size > 0, f"campaign wrote no {name}")
        rows[name] = len(p.read_text().strip().splitlines()) - 1
    check(rows[campaign.R_CSV] == 30, f"expected 30 direct cases: {rows}")
    log(f"  campaign, 1 anatomy: {dt:.1f} s, rows {rows}")


def phase_four_cards(size: int) -> None:
    import jax
    import jax.numpy as jnp

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.parallel import sharding
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 devices, "
          f"JAX sees {len(jax.devices())}")
    cfg = MusicaConfig(image_size=size)
    imgs = np.stack([synthetic_radiograph(size, a) for a in ANATOMIES])
    t0 = time.perf_counter()
    single = np.stack([np.asarray(musica.process_jit(jnp.asarray(im), cfg))
                       for im in imgs])
    log(f"  single-device reference: {time.perf_counter() - t0:.2f} s")
    for n_data, n_space in ((4, 1), (2, 2)):
        mesh = sharding.make_mesh(n_data=n_data, n_space=n_space)
        t0 = time.perf_counter()
        out = np.asarray(sharding.process_sharded(imgs, cfg, mesh))
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = np.asarray(sharding.process_sharded(imgs, cfg, mesh))
        warm = time.perf_counter() - t0
        d = np.abs(out.astype(np.int32) - single.astype(np.int32))
        log(f"  data={n_data} x space={n_space}: {dt:.2f} s with compile, "
            f"{warm:.3f} s warm for {len(imgs)} images; max|du8| "
            f"{int(d.max())}, differing {float((d > 0).mean()):.2e}")
        if n_space == 1:
            check(d.max() == 0, "data-parallel output != single-device")
        else:
            # row-sharded programs may move 1-ulp f32 roundings across the
            # truncating u8 cast (tests/test_sharding.py ragged-size note)
            check(d.max() <= 1 and (d > 0).mean() < 1e-4,
                  "row-sharded output differs beyond 1 LSB on 1e-4")


def run_phases(size: int, clahe_size: int, work: Path) -> None:
    """Phases 2-6 (phase 1, the GPU check, is main's); ``work`` holds the
    raws and outputs and is removed at the end."""
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        _run_phases(size, clahe_size, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run_phases(size: int, clahe_size: int, work: Path) -> None:
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph

    clahe_variant = {"enable_clahe": True, "grad_with_linear_image": True}
    with ProcessPoolExecutor(max_workers=2,
                             mp_context=get_context("spawn")) as pool:
        gold = pool.submit(golden_job, size, "thorax", {})
        gold_clahe = pool.submit(golden_job, clahe_size, "thorax",
                                 clahe_variant)

        t0 = time.perf_counter()
        log("phase 2: build the native codec")
        subprocess.run(["make", "-s", "-C", str(REPO / "native")], check=True)
        from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as uio
        check(uio.have_native_codec(), "native codec did not load")
        log(f"  built and loaded in {time.perf_counter() - t0:.2f} s")

        log(f"phase 3: cli process / batch at {size}^2")
        phase_cli(size, work)

        log(f"phase 4: parity with the golden model at {size}^2")
        cfg = MusicaConfig(image_size=size)
        img = synthetic_radiograph(size, "thorax")
        t0 = time.perf_counter()
        dev = device_outputs(img, cfg)
        log(f"  device pass: {time.perf_counter() - t0:.2f} s (includes "
            "compile)")
        phase_bf16(img, cfg, dev["out_u8"])
        compare_with_golden("default", dev, gold.result())

        log(f"  CLAHE + linear gradation at {clahe_size}^2")
        ccfg = MusicaConfig(image_size=clahe_size, **clahe_variant)
        cimg = synthetic_radiograph(clahe_size, "thorax")
        cdev = device_outputs(cimg, ccfg)
        cgold = gold_clahe.result()
        compare_with_golden("clahe+linear", cdev, cgold)
        phase_clahe(cdev, cgold)

        log("phase 5: histogram counts on the card vs np.bincount")
        phase_hist_exact(img, cfg)

        log(f"phase 6: campaign at {size}^2, one anatomy")
        phase_campaign(size, work)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards (phase 7)")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import device
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils.compile_cache import enable_compile_cache

    log("phase 1: device")
    try:
        dev = device.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    log(f"  card: {device.card_line()}")
    log(f"  jax: {dev.platform} {dev.device_kind} x "
        f"{device.device_record()['count']}")
    log(f"  compile cache: {enable_compile_cache()}")

    try:
        if args.four_cards:
            log(f"phase 7: process_sharded at {SIZE}^2 on four cards")
            phase_four_cards(SIZE)
        else:
            run_phases(SIZE, CLAHE_SIZE, WORK)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    peak = dev.memory_stats().get("peak_bytes_in_use")
    log(f"peak_bytes_in_use: {peak}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(f"card: {device.card_line()}")
    print(json.dumps({"ok": True, "device": device.device_record()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
