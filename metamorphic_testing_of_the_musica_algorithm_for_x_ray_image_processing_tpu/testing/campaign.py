"""The metamorphic-testing campaign.

Port of ``test/metamorphic_test/script.py`` (module body, :216-664): for each
anatomy, process the unaltered raw, then every perturbation of every MR
family, and measure similarity (a) against the pipeline's own unaltered
output -- robustness, (b) against a reference image -- fidelity, (c) after
registration normalization (cropping/aligning both to the altered region,
accounting for the margin-10 processing crop).  Writes the same three CSVs:

  direct_robustness.csv / reg_based_robustness.csv / ref_similarities.csv

Differences from the reference harness:
  * the system under test is called in-process (one jit-compiled function)
    instead of ~160 subprocess launches of a Vulkan exe; a ``runner`` hook
    allows substituting any other implementation (e.g. the golden model);
  * anatomy raws are synthesized (the reference's are missing from its
    snapshot); pass ``input_dir`` with ``<anatomy>/image.raw`` files to use
    real data, and DICOM references are loaded when pydicom is available.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from ..config import MusicaConfig
from ..utils import io as uio
from . import metrics, perturb
from .phantoms import ANATOMIES, synthetic_radiograph

PROCESSING_MARGIN = 10

R_CSV = "direct_robustness.csv"
NR_CSV = "reg_based_robustness.csv"
S_CSV = "ref_similarities.csv"

_ROBUSTNESS_HEADER = [
    "raw file", "alteration",
    "altered vs unaltered mse", "altered vs unaltered ssim",
    "altered vs unaltered histogram distance",
    "altered vs reference mse", "altered vs reference ssim",
    "altered vs reference histogram distance",
    "normalized altered vs reference mse",
    "normalized altered vs reference ssim",
    "normalized altered vs reference histogram distance",
]


def _measure_row(alt, unalt, ref, ovd):
    """Six similarity numbers + the three reference-normalized ratios.

    With an accelerator, all six numbers come from ONE fused jitted call
    (metrics.measure_row_device); ``unalt``/``ref`` that are already device
    arrays stay there, so only ``alt`` crosses the host boundary.  The f64
    host oracles are the no-accelerator path."""
    if not isinstance(unalt, np.ndarray) or metrics.device_metrics_available():
        import jax.numpy as jnp
        (own_mse, own_ssim, own_hist, ref_mse, ref_ssim,
         ref_hist) = metrics.measure_row_device(
             alt, jnp.asarray(unalt), jnp.asarray(ref))
    else:
        own_mse = metrics.mse_similarity(alt, unalt)
        own_ssim = metrics.ssim_similarity(alt, unalt)
        _, own_hist, _ = metrics.hist_similarity(alt, unalt)
        ref_mse = metrics.mse_similarity(alt, ref)
        ref_ssim = metrics.ssim_similarity(alt, ref)
        _, ref_hist, _ = metrics.hist_similarity(alt, ref)
    ovd_mse, ovd_ssim, ovd_hist = ovd
    return [own_mse, own_ssim, own_hist, ref_mse, ref_ssim, ref_hist,
            ref_mse / ovd_mse, ref_ssim / ovd_ssim,
            (ref_hist - ovd_hist) / (1.0 - ovd_hist) if ovd_hist != 1.0 else 0.0]


def default_runner(image_size: int, quirks: bool = True,
                   transpose: bool = True,
                   storage: str = "float32") -> Callable:
    """In-process system under test: raw array (file layout) -> output u8.

    Applies the standalone CLI's transpose on load
    (test/standalone/main.cpp:67-75) so results match `cli process`;
    ``transpose=False`` mirrors `cli process --no-transpose`.

    ``storage="bfloat16"`` runs the campaign against the bf16 fast mode
    (cli: ``campaign --bf16``) -- the MT harness then measures whether the
    fast mode preserves the metamorphic robustness profile.
    """
    from ..models import musica
    import jax.numpy as jnp
    cfg = MusicaConfig(image_size=image_size, quirks=quirks, storage=storage)

    def run(raw_u16: np.ndarray) -> np.ndarray:
        im = raw_u16.T if transpose else raw_u16
        return np.asarray(musica.process_jit(jnp.asarray(im), cfg))

    return run


def dicom_to_reference(arr: np.ndarray) -> np.ndarray:
    """DICOM pixel array -> 8-bit inverted ground-truth image
    (test/metamorphic_test/script.py:396-405).

    The reference's 16-bit path is PIL ``point(lambda i: i * (1/256))
    .convert('L')`` on an I;16 image = truncating v // 256, then
    ``ImageOps.invert`` = 255 - v; verified equal to that exact PIL chain in
    tests/test_dicom_reference.py."""
    if arr.dtype != np.uint8:
        arr = (arr / 256).astype(np.uint8)
    return (255 - arr).astype(np.uint8)


def load_reference_image(path: str, size: int) -> Optional[np.ndarray]:
    """Vendor-processed DICOM ground truth, 16->8 bit + inverted
    (script.py:396-405).  Returns None when pydicom is unavailable."""
    try:
        import pydicom
    except ImportError:
        return None
    ds = pydicom.dcmread(path)
    return dicom_to_reference(ds.pixel_array)


def run_campaign(out_dir: str = "mt_out", image_size: int = 3072,
                 anatomies: Optional[Sequence[str]] = None,
                 input_dir: Optional[str] = None,
                 runner: Optional[Callable] = None,
                 seed: int = 0,
                 save_images: bool = False,
                 quirks: bool = True,
                 transpose: bool = True,
                 storage: str = "float32") -> dict:
    """Run the full campaign; returns {csv_name: rows} and writes the CSVs.

    ``quirks``/``transpose``/``storage`` configure the default in-process
    runner (they are ignored when an explicit ``runner`` is passed);
    ``save_images`` mirrors the reference harness, which saves every
    altered input raw and processed BMP per case (script.py:417-421)."""
    t_start = time.time()
    anatomies = list(anatomies or ANATOMIES)
    runner = runner or default_runner(image_size, quirks=quirks,
                                      transpose=transpose,
                                      storage=storage)
    rng = np.random.default_rng(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    trans = perturb._scaled(perturb.TRANSLATIONS, image_size)
    shutters = perturb._scaled(perturb.COLLIMATOR_SHUTTERS, image_size)

    results = {R_CSV: [_ROBUSTNESS_HEADER],
               NR_CSV: [_ROBUSTNESS_HEADER],
               S_CSV: [["raw file", "mse similarity", "ssim similarity",
                        "histogram distance"]]}

    def save_case(name, img_u8, raw_u16=None):
        """Mirror the reference's per-case artifacts: the altered input raw
        (save_image, script.py:417-421 -- zero-filled 256-byte header) plus
        the processed BMP output."""
        if save_images:
            uio.save_bmp8(out / f"{name}.bmp", img_u8)
            if raw_u16 is not None:
                uio.save_raw(out / f"{name}.raw", raw_u16)

    for anat in anatomies:
        if input_dir:
            raw = uio.load_raw(Path(input_dir) / anat / "image.raw",
                               image_size, transpose=False)
            ref_path = Path(input_dir) / anat / "proc"
            reference = (load_reference_image(str(ref_path), image_size)
                         if ref_path.exists() else None)
        else:
            raw = synthetic_radiograph(image_size, anat)
            reference = None

        unalt = runner(raw)
        save_case(f"{anat}_unaltered", unalt)
        if reference is None:
            # no vendor ground truth: the unaltered output is the reference
            reference = unalt
        else:
            m = PROCESSING_MARGIN
            reference = reference[m:image_size - m, m:image_size - m]

        # device-resident copies for the fused metric path (uploaded once
        # per anatomy; every _measure_row then ships only the altered image)
        use_dev = metrics.device_metrics_available()
        if use_dev:
            import jax.numpy as jnp
            unalt_m = jnp.asarray(unalt)
            reference_m = (unalt_m if reference is unalt
                           else jnp.asarray(reference))
            vals = metrics.measure_row_device(unalt, unalt_m, reference_m)
            ovd = (vals[3], vals[4], vals[5])
        else:
            unalt_m, reference_m = unalt, reference
            ovd = (metrics.mse_similarity(unalt, reference),
                   metrics.ssim_similarity(unalt, reference),
                   metrics.hist_similarity(unalt, reference)[1])
        results[S_CSV].append([anat, *ovd])

        def direct(name, alt_img):
            alt_out = runner(alt_img)
            save_case(f"{anat}_{name}", alt_out, raw_u16=alt_img)
            results[R_CSV].append(
                [anat, name, *_measure_row(alt_out, unalt_m, reference_m,
                                           ovd)])
            return alt_out

        # collimator (+ registration-normalized: crop to the open window)
        for shutter in shutters:
            name = f"c_sh_{shutter}"
            alt_out = direct(name, perturb.apply_collimator(raw, shutter, shutter, rng))
            x = shutter + PROCESSING_MARGIN
            wdt = alt_out.shape[1] - (2 * shutter + 2 * PROCESSING_MARGIN)
            if wdt > 32:
                sl = (slice(x, x + wdt), slice(x, x + wdt))
                results[NR_CSV].append(
                    [anat, name, *_measure_row(alt_out[sl], unalt[sl],
                                               reference[sl], ovd)])

        # translation x / y (normalized: overlap region)
        for t, axis in [(tx, "x") for tx in trans] + [(ty, "y") for ty in trans]:
            name = f"t_{axis}_{t}"
            if axis == "x":
                alt_img = perturb.clamp_translation(raw, x_shift=t)
            else:
                alt_img = perturb.clamp_translation(raw, y_shift=t)
            alt_out = direct(name, alt_img)
            n = alt_out.shape[0]
            if axis == "x":
                a_sl = (slice(0, n), slice(t, n))
                u_sl = (slice(0, n), slice(PROCESSING_MARGIN, n - t + PROCESSING_MARGIN))
            else:
                a_sl = (slice(t, n), slice(0, n))
                u_sl = (slice(PROCESSING_MARGIN, n - t + PROCESSING_MARGIN), slice(0, n))
            if n - t > 32:
                results[NR_CSV].append(
                    [anat, name, *_measure_row(alt_out[a_sl], unalt[u_sl],
                                               reference[u_sl], ovd)])

        # rotation (normalized: largest inner rect of the back-rotated pair)
        for deg in perturb.ROTATIONS:
            name = f"r_{deg}"
            alt_out = direct(name, perturb.clamp_rotate(raw, deg))
            h, w = alt_out.shape
            l, tp, r, btm = perturb.inner_rect_after_rotation(w, h, deg)
            rot_u = perturb.rotate_nearest(unalt, deg)
            rot_r = perturb.rotate_nearest(reference, deg)
            sl = (slice(tp, btm), slice(l, r))
            results[NR_CSV].append(
                [anat, name, *_measure_row(alt_out[sl], rot_u[sl],
                                           rot_r[sl], ovd)])

        # gaussian noise (direct only, as in the reference)
        for sd in perturb.GAUSSIAN_SIGMAS:
            direct(f"gn_{sd}", perturb.add_gaussian_noise(raw, 0.0, sd, rng))

        # quantum noise (direct only)
        for fac in perturb.QUANTUM_FACTORS:
            direct(f"pn_{fac}", perturb.apply_quantum_noise(raw, fac, rng))

    for name, rows in results.items():
        with open(out / name, "w", newline="") as f:
            csv.writer(f).writerows(rows)

    # the delta table (reference: test/reg_vs_dir_delta/results.csv) feeding
    # the slope analysis
    from .analysis import build_delta_table
    deltas = build_delta_table(results[R_CSV])
    with open(out / "deltas.csv", "w", newline="") as f:
        csv.writer(f, delimiter=";").writerows(deltas)
    results["deltas.csv"] = deltas

    print(f"campaign: {len(anatomies)} anatomies, "
          f"{len(results[R_CSV]) - 1} cases, "
          f"{(time.time() - t_start) / 60:.1f} min")
    return results
