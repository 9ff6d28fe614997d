"""Command-line interface.

``process`` mirrors the reference standalone CLI exactly
(``maverick-standalone.exe <raw> <out.bmp>``, test/standalone/main.cpp):
3072^2 raw with 256-byte header, loaded transposed, margin-10-cropped 8-bit
BMP out, optional intermediate dump (the debug build's debugProcess).

Additional subcommands expose the wider framework: batch processing over a
directory, the metamorphic campaign, and the analysis tools.

Usage:
    python -m metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.cli process in.raw out.bmp
    python -m ...cli process --size 3072 --debug-dump dbg/ in.raw out.bmp
    python -m ...cli batch --size 3072 'raws/*.raw' outdir/
    python -m ...cli campaign --size 1024 --out-dir out/
    python -m ...cli slope-analysis results.csv
"""

from __future__ import annotations

import argparse
import glob
import sys
import time


def _add_common(p):
    p.add_argument("--size", type=int, default=3072,
                   help="square image size (reference standalone: 3072)")
    p.add_argument("--no-transpose", action="store_true",
                   help="skip the reference CLI's transposed raw load")
    p.add_argument("--no-quirks", action="store_true",
                   help="clean math instead of bit-faithful GPU quirks")
    p.add_argument("--platform", default=None,
                   help="force a JAX platform (cpu/gpu)")


def _force_platform(platform: str) -> None:
    """Force the JAX backend for this process (through ``jax.config``, which
    also works when jax was imported before the CLI ran)."""
    import jax

    jax.config.update("jax_platforms", platform)


def cmd_process(args) -> int:
    if args.platform:
        _force_platform(args.platform)
    import numpy as np
    import jax.numpy as jnp
    from .config import MusicaConfig
    from .models import musica
    from .utils import io as uio
    from .utils.debug import dump_intermediates

    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks,
                       enable_clahe=args.clahe,
                       grad_with_linear_image=args.linear_gradation,
                       storage="bfloat16" if args.bf16 else "float32")
    raw = uio.load_raw(args.input, args.size, transpose=not args.no_transpose)
    if args.save_last_raw:
        # saveLastRawImage analogue (src/vk_processing.cpp:2811-2815)
        uio.save_raw(args.save_last_raw, raw)
    if args.cnr_out:
        # CNR_DEBUG analogue (shaders/cnr_debug.comp): the CNR map as a
        # grayscale BMP, the input format of `mean-cnr`
        import jax
        res = jax.jit(lambda im: musica.musica_forward(im, cfg)["cnr"]
                      )(jnp.asarray(raw))
        uio.save_bmp8(args.cnr_out, np.clip(
            np.asarray(res) * 255.0, 0, 255).astype(np.uint8))
    tracing = False
    if args.profile:
        # deep-profiling analogue of the reference's MSVC /PROFILE link flag
        # (CMakeLists.txt:14-16): captures an XPlane trace (host + device
        # timelines, XLA HLO annotations) viewable in TensorBoard/Perfetto.
        # Degrades to a warning where the backend can't trace.
        import jax
        try:
            jax.profiler.start_trace(args.profile)
            tracing = True
        except Exception as e:  # noqa: BLE001 - profiling must never break processing
            print(f"profiler unavailable ({type(e).__name__}: {e})",
                  file=sys.stderr)
    t0 = time.perf_counter()
    if args.timing:
        # MEASURE_PROCESS analogue: per-phase fenced timing
        out, times = musica.timed_process(raw, cfg)
        print(" \t ".join(f"{k}: {v:.2f}" for k, v in times.items()))
    elif args.debug_dump:
        import jax
        fwd = jax.jit(
            lambda im: musica.musica_forward(im, cfg, want_intermediates=True),
            static_argnums=())
        res = fwd(jnp.asarray(raw))
        out = np.asarray(res["out_u8"])
        inter = {k: (v if isinstance(v, tuple) else np.asarray(v))
                 for k, v in res["intermediates"].items()}
        dump_intermediates(inter, args.debug_dump)
    else:
        out = musica.process(raw, cfg)
    dt = time.perf_counter() - t0
    if tracing:
        import jax
        jax.block_until_ready(out)  # device activity lands in the trace
        jax.profiler.stop_trace()
        print(f"profile trace -> {args.profile}")
    uio.save_bmp8(args.output, out)
    mpix = args.size * args.size / 1e6
    print(f"processed {args.input} ({args.size}^2, {mpix:.1f} MPix) "
          f"in {dt * 1e3:.1f} ms (incl. compile) -> {args.output}")
    return 0


def cmd_batch(args) -> int:
    import numpy as np
    import jax.numpy as jnp
    from .config import MusicaConfig
    from .models import musica
    from .utils import io as uio

    files = sorted(glob.glob(args.pattern))
    if not files:
        print(f"no files match {args.pattern}", file=sys.stderr)
        return 1
    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks,
                       storage="bfloat16" if args.bf16 else "float32")
    import os
    os.makedirs(args.out_dir, exist_ok=True)
    B = max(1, args.batch)
    t0 = time.perf_counter()

    def save_chunk(chunk, outs_dev):
        # np.asarray waits for the async device dispatch
        for f, out in zip(chunk, np.asarray(outs_dev)):
            name = os.path.splitext(os.path.basename(f))[0] + ".bmp"
            uio.save_bmp8(os.path.join(args.out_dir, name), out)

    # dispatch-ahead: enqueue chunk k+1 on the device (jax dispatch is
    # async) before fetching/saving chunk k, so host IO overlaps compute
    pending = None
    for start in range(0, len(files), B):
        chunk = files[start:start + B]
        raws = np.stack([uio.load_raw(f, args.size,
                                      transpose=not args.no_transpose)
                         for f in chunk])
        if len(chunk) < B:
            # pad the last chunk so every dispatch reuses one compiled shape
            raws = np.concatenate(
                [raws, np.zeros((B - len(chunk),) + raws.shape[1:],
                                raws.dtype)])
        raws_dev = jnp.asarray(raws)
        outs_dev = musica.process_batch_jit(raws_dev, cfg)
        if pending is not None:
            save_chunk(*pending)
        pending = (chunk, outs_dev)
    if pending is not None:
        save_chunk(*pending)
    dt = time.perf_counter() - t0
    print(f"{len(files)} images in {dt:.2f}s "
          f"({len(files) * args.size ** 2 / dt / 1e9:.3f} GPix/s incl. IO+compile)")
    return 0


def cmd_report(args) -> int:
    from .config import MusicaConfig
    from .utils import io as uio
    from .utils.report import write_report

    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks)
    raw = uio.load_raw(args.input, args.size, transpose=not args.no_transpose)
    index = write_report(raw, args.out_dir, cfg, title=args.input)
    print(f"report -> {index}")
    return 0


def cmd_view(args) -> int:
    if args.platform:
        _force_platform(args.platform)
    from .config import MusicaConfig
    from .utils.viewer import serve

    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks)
    serve(args.input, cfg, transpose=not args.no_transpose,
          host=args.host, port=args.port, report_dir=args.report_dir)
    return 0


def cmd_campaign(args) -> int:
    if args.platform:
        _force_platform(args.platform)
    from .testing.campaign import run_campaign
    run_campaign(out_dir=args.out_dir, image_size=args.size,
                 anatomies=args.anatomies.split(",") if args.anatomies else None,
                 input_dir=args.input_dir,
                 seed=args.seed,
                 save_images=args.save_images,
                 quirks=not args.no_quirks,
                 transpose=not args.no_transpose,
                 storage="bfloat16" if args.bf16 else "float32")
    return 0


def cmd_slope(args) -> int:
    from .testing.analysis import slope_analysis_file
    for line in slope_analysis_file(args.csv, out_file=args.out,
                                    wilcoxon=args.wilcoxon):
        print(line)
    return 0


def cmd_mean_cnr(args) -> int:
    from .testing.analysis import mean_cnr_dir
    for name, val in mean_cnr_dir(args.in_dir, out_file=args.out):
        print(f"{name} \t {val}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="musica-tpu",
                                 description="MUSICA X-ray enhancement "
                                             "pipeline in JAX")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process", help="raw in -> processed BMP out")
    _add_common(p)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--debug-dump", default=None,
                   help="directory for intermediate-image BMPs (debugProcess)")
    p.add_argument("--timing", action="store_true",
                   help="per-phase fenced timing (MEASURE_PROCESS analogue)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler XPlane trace of the run into "
                        "DIR (TensorBoard/Perfetto-viewable; /PROFILE "
                        "analogue)")
    p.add_argument("--save-last-raw", default=None,
                   help="re-save the loaded raw (saveLastRawImage analogue)")
    p.add_argument("--cnr-out", default=None,
                   help="write the CNR map as BMP (CNR_DEBUG analogue; "
                        "feeds the mean-cnr subcommand)")
    p.add_argument("--clahe", action="store_true",
                   help="enable the CLAHE gradation variant (ENABLE_CLAHE)")
    p.add_argument("--linear-gradation", action="store_true",
                   help="grade the squared image (GRAD_WITH_LINEAR_IMAGE)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 storage for the pyramid band streams (fast "
                        "mode, config.py storage=\"bfloat16\"; level inputs "
                        "and the analysis path stay f32 -- output tracks "
                        "the parity mode within ~1 LSB on most pixels, up "
                        "to ~a dozen LSB where the data-dependent tone "
                        "curve's knots shift a bin; intended for images "
                        ">= 512 px, see tests/test_bf16.py)")
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("batch", help="process a glob of raw files")
    _add_common(p)
    p.add_argument("pattern")
    p.add_argument("out_dir")
    p.add_argument("--batch", type=int, default=4,
                   help="images per device dispatch (lax.map chunk; the "
                        "last chunk is zero-padded to reuse one compiled "
                        "shape)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 storage for the pyramid band streams (fast "
                        "mode; see `process --bf16`)")
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("report", help="HTML gallery of all pipeline stages "
                                      "(the GUI viewer's headless analogue)")
    _add_common(p)
    p.add_argument("input")
    p.add_argument("out_dir")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("view", help="interactive HTTP viewer (the GLFW/"
                                    "ImGui app shell's live analogue: "
                                    "double-buffered out image, render "
                                    "panels, execute/debugProcess buttons)")
    _add_common(p)
    p.add_argument("input", help="raw input image (re-read on each execute)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--report-dir", default="viewer_report",
                   help="debugProcess() output directory")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("campaign", help="run the metamorphic-testing campaign")
    _add_common(p)
    p.add_argument("--out-dir", default="mt_out")
    p.add_argument("--anatomies", default=None,
                   help="comma-separated subset of foot,hand,head,knee,pelvis,thorax")
    p.add_argument("--input-dir", default=None,
                   help="directory of real anatomy data (<anatomy>/image.raw "
                        "+ optional <anatomy>/proc vendor DICOM ground "
                        "truth, the reference harness's INPUT_PATH layout); "
                        "default: synthetic phantoms")
    p.add_argument("--save-images", action="store_true",
                   help="save every altered input raw and processed BMP per "
                        "case (script.py:417-421 save_image behavior)")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for the noise/collimator perturbations")
    p.add_argument("--bf16", action="store_true",
                   help="run the campaign against the bf16 fast mode "
                        "(storage=\"bfloat16\") -- measures whether the "
                        "fast mode preserves the metamorphic robustness "
                        "profile (see `process --bf16`)")
    p.set_defaults(fn=cmd_campaign)

    p = sub.add_parser("slope-analysis",
                       help="per-alteration linear-regression slope test")
    p.add_argument("csv")
    p.add_argument("--out", default=None)
    p.add_argument("--wilcoxon", action="store_true",
                   help="also run the Wilcoxon signed-rank test per group "
                        "(the reference's commented-out branch, "
                        "test/reg_vs_dir_delta/script.py:30-33)")
    p.set_defaults(fn=cmd_slope)

    p = sub.add_parser("mean-cnr", help="mean CNR of debug BMPs in a directory")
    p.add_argument("in_dir")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_mean_cnr)

    args = ap.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
