"""The MUSICA pipeline as one pure, jit-compiled JAX function.

The reference drives ~100 ``VulkanCompute`` pipeline objects through a
binary-semaphore DAG (``VulkanProcessing::execute``,
src/vk_processing.cpp:2104-2601).  Here the whole forward pass is a single
traced function over statically-shaped pyramid levels; XLA performs the
scheduling, fusion and memory planning that the semaphores and ~60
intermediate Vulkan images did.

Phase map (reference -> here):
  2. normalize        -> ops.normalize (sqrt + quirk-exact global max/min)
  3. pyramid reduce   -> ops.pyramid (fused smooth+decimate; zero-stuff+smooth*4)
  4. image analysis   -> ops.stats (sdev, noise histogram, argmax) + ops.curves
  5. apply            -> ops.curves (contrast gain), ops.noise (CNR, NR)
  6. pyramid expand   -> ops.pyramid
  7. gradation        -> ops.noise (relevance) + ops.gradation
  output              -> margin crop + x255 truncating u8 cast
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import MusicaConfig
from ..ops import curves, gradation, noise, normalize, pyramid, stats

F32 = jnp.float32

# Default interleave group for the production batch path
# (process_batch_jit).  Not yet tuned on the GPU.  Batches not divisible
# by g fall back to the largest divisor (bit-identical for any g).
DEFAULT_INTERLEAVE = 4


def _storage(cfg: MusicaConfig):
    """Storage dtype of the band streams (config.py ``storage``)."""
    return jnp.bfloat16 if cfg.storage == "bfloat16" else F32


def _effective_interleave(batch: int, g: int) -> int:
    """Largest g' <= g that divides ``batch`` (1 if g <= 1)."""
    g = max(1, min(g, batch))
    while batch % g:
        g -= 1
    return g


def musica_forward(img_u16: jnp.ndarray, cfg: MusicaConfig,
                   want_intermediates: bool = False):
    """Full MUSICA pass on one [n, n] uint16 image -> dict of outputs.

    Returns at least ``graded`` ([n, n] f32 in [0, 1]) and ``out_u8``
    (margin-cropped uint8).  With ``want_intermediates`` also every stage
    image (the equivalent of the reference's debugProcess dump surface,
    src/vk_processing.cpp:2661-2809).
    """
    L = cfg.pyramid_levels
    inter: Dict[str, object] = {}
    # Storage dtype of the BAND streams (config.py "bfloat16"): bandpass,
    # exp_bandpass and nr_bandpass are stored bf16; every .astype below is
    # an identity no-op in the default f32 mode.
    #
    # Why only the band streams: a band is `in - low`, a near-cancelling
    # difference of two ~0.5-magnitude images whose own magnitude is ~0.01
    # at fine levels.  If the LEVEL INPUTS are bf16-quantized (the round-4
    # design), the quantization noise q (~ulp(0.5) = 2e-3, high-frequency)
    # passes straight into the band: band' = band + highpass(q).  The noise
    # ANALYSIS then measures the quantization instead of the image -- the
    # level-3 sdev inflates ~20%, CNR crosses the relevance cliff at 256,
    # and the data-dependent gradation curve shifts by tens of u8 LSB on
    # some anatomies.  Rounding the COMPUTED band to bf16 instead is an
    # error RELATIVE to the band (~0.4%), benign for sdev/histograms/CNR
    # and for reconstruction.  So: normalized, downs and the recon
    # accumulation stay f32; bands are written/read half-width.
    sd = _storage(cfg)

    # ---- phase 2: normalize -------------------------------------------------
    normalized, vmax, vmin = normalize.normalize_from_u16(img_u16, cfg.quirks)

    # ---- phase 3: pyramid reduce -------------------------------------------
    # parity-plane ladder (ops/pyramid.py::reduce_ladder): bit-identical to
    # smooth_downsample + upsample_smooth per level, unit-stride stencils,
    # f32 arithmetic.  The bf16 band cast fuses into the ladder's band
    # producer, so the band WRITE is half-width without an extra pass.
    bandpass, downs = pyramid.reduce_ladder(normalized, L)
    bandpass = [b.astype(sd) for b in bandpass]

    # ---- phase 4: analysis --------------------------------------------------
    sdevs: Dict[int, jnp.ndarray] = {}
    for i in cfg.analysis_levels:
        # f32 sdev whatever the storage dtype: the upcast fuses into the
        # 5x5 RMS stencil, so the HBM read stays half-width in bf16 mode
        sdevs[i] = stats.img_sdev(bandpass[i].astype(F32))
    hists, max_bins = stats.analysis_noise_hists(sdevs, cfg)
    if want_intermediates:
        for i in cfg.analysis_levels:
            inter[f"noise_hist_{i}"] = hists[i]

    curve_list = []
    for i in range(L):
        lcf, hcf = cfg.contrast_factors[i]
        mb = max_bins.get(i, jnp.zeros((), jnp.int32))
        curve_list.append(curves.contrast_curve(mb, lcf, hcf, cfg))

    # ---- phase 5: apply -----------------------------------------------------
    cnr = noise.img_cnr(sdevs[cfg.cnr_level], max_bins[cfg.cnr_level], cfg)

    exp_bandpass = []
    for i in range(L):
        px, py = curve_list[i]
        if i in sdevs:
            # f32 getY chain; the bf16 upcast fuses into it
            eb = curves.contrast_curve_apply(bandpass[i].astype(F32),
                                             sdevs[i], px, py)
        else:
            # sdev is never computed for these levels in the reference (the
            # shader reads stale memory); the flat 2-point curve gives a
            # constant hcf gain for any sdev in [0, 1].
            eb = bandpass[i].astype(F32) * jnp.float32(
                cfg.contrast_factors[i][1])
        exp_bandpass.append(eb.astype(sd))

    nr_bandpass: Dict[int, jnp.ndarray] = {}
    for lvl in range(cfg.cnr_level):
        lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[lvl]
        nr_bandpass[lvl] = noise.noise_reduction(
            exp_bandpass[lvl], cnr, lo_c, lo_f, hi_c, hi_f, cfg).astype(sd)

    # ---- phase 6: pyramid expand -------------------------------------------
    # Only levels < cnr_level - 1 consume the noise-reduced bandpass
    # (src/vk_processing.cpp:1043-1049); level cnr_level-1's NR image is
    # computed but unused, mirrored here for the debug surface only.
    #
    # The recon accumulation stays f32 in bf16 mode (downs are f32, bands
    # upcast at the addition): the gradation histogram (1024 bins over
    # [0, 1]) reads recon, and a bf16 recon would be quantized to ~2-bin
    # spacing in [0.5, 1) (bf16 ulp 2^-9 vs bin width 2^-10) -- a comb
    # histogram that derails gradation_curve's t0/t1 threshold walks.
    recon = downs[L - 1]
    for i in range(L):
        lvl = L - 1 - i
        low = pyramid.upsample_smooth(recon, bandpass[lvl].shape[-1])
        band = nr_bandpass[lvl] if lvl < cfg.cnr_level - 1 else exp_bandpass[lvl]
        recon = low + band.astype(F32)
        if want_intermediates:
            inter[f"exp_lowpass_{i}"] = low

    # ---- phase 7: gradation -------------------------------------------------
    # GRAD_WITH_LINEAR_IMAGE variant (shaders/img_linear.comp: out = in^2;
    # wiring at src/vk_processing.cpp:1623-1629, 1769-1775): the gradation
    # histogram and tone-map operate on the squared (linear-domain) image.
    grad_input = recon * recon if cfg.grad_with_linear_image else recon
    relevant = noise.img_relevant(normalized, cnr, cfg)
    if cfg.enable_clahe:
        from ..ops import clahe as clahe_ops
        clahe_graded = clahe_ops.clahe_grade(recon, relevant, cfg)
    ghist = gradation.gradation_histogram(grad_input, relevant, cfg)
    gpx, gpy, tvals = gradation.gradation_curve(ghist, cfg)

    # Tone map crop-FIRST (elementwise, so cropping commutes bit-exactly)
    # with the u8 quantization fused into the branchless general getY chain
    # (one elementwise pass, no runtime lax.cond; ops/curves.py).
    m = cfg.out_margin
    out_u8 = curves.curve_apply_u8_adaptive(
        gpx, gpy, grad_input[..., m:-m, m:-m].astype(F32))
    # full-res graded image: API/debug surface only -- XLA dead-code
    # eliminates it for callers that consume just out_u8
    graded = curves.curve_get_y_adaptive(gpx, gpy, grad_input.astype(F32))
    result = {"graded": graded, "out_u8": out_u8, "recon": recon, "cnr": cnr}
    if cfg.enable_clahe:
        result["clahe_graded"] = clahe_graded
    if want_intermediates:
        inter.update({
            "normalized": normalized,
            "relevant": relevant,
            "grad_hist": ghist,
            "grad_curve": (gpx, gpy, tvals),
            "sqrt_max": vmax, "sqrt_min": vmin,
        })
        if cfg.grad_with_linear_image:
            inter["linear"] = grad_input
        for i, b in enumerate(bandpass):
            inter[f"red_bandpass_{i}"] = b
        for i, d in enumerate(downs):
            inter[f"downsampled_{i}"] = d
        for i, sdv in sdevs.items():
            inter[f"sdev_{i}"] = sdv
        for i, mb in max_bins.items():
            inter[f"noise_max_bin_{i}"] = mb
        for i, eb in enumerate(exp_bandpass):
            inter[f"contrast_bandpass_{i}"] = eb
        for lvl, nb in nr_bandpass.items():
            inter[f"nr_bandpass_{lvl}"] = nb
        for i, (px, py) in enumerate(curve_list):
            inter[f"contrast_curve_{i}"] = (px, py)
        result["intermediates"] = inter
    return result


@partial(jax.jit, static_argnames=("cfg",))
def process_jit(img_u16: jnp.ndarray, cfg: MusicaConfig) -> jnp.ndarray:
    """jit entry: one image in, cropped uint8 out."""
    return musica_forward(img_u16, cfg)["out_u8"]


@partial(jax.jit, static_argnames=("cfg", "interleave"))
def process_batch_jit(imgs_u16: jnp.ndarray, cfg: MusicaConfig,
                      interleave: int = DEFAULT_INTERLEAVE) -> jnp.ndarray:
    """Batch entry: [B, n, n] uint16 -> [B, n-2m, n-2m] uint8.

    Uses ``lax.map`` (sequential per-image execution of the single-image
    program), not ``vmap``.  ``interleave=g`` (reduced to the largest
    divisor of B) maps over GROUPS of g images, each group traced as g
    independent single-image programs in one map body: same per-image
    layouts, but the scheduler gets g independent dataflows to overlap.
    Bit-identical to ``interleave=1`` for any g.  Neither choice has been
    re-measured against ``vmap`` on the GPU yet.
    """
    B = imgs_u16.shape[0]
    g = _effective_interleave(B, interleave)
    grouped = imgs_u16.reshape(B // g, g, *imgs_u16.shape[1:])
    out = jax.lax.map(
        lambda grp: jnp.stack(
            [musica_forward(grp[i], cfg)["out_u8"] for i in range(g)]),
        grouped)
    return out.reshape(B, *out.shape[2:])


def process(img_u16, cfg: Optional[MusicaConfig] = None):
    """Convenience host API mirroring the golden model's signature."""
    import numpy as np
    img = jnp.asarray(np.asarray(img_u16))
    cfg = cfg or MusicaConfig(image_size=img.shape[-1])
    return np.asarray(process_jit(img, cfg))


# The phases of timed_process, each its own program (built once per config,
# so repeated timed calls reuse the compilations).
@partial(jax.jit, static_argnames=("cfg",))
def _phase_norm(im, cfg):
    s = normalize.img_sqrt(im)
    return normalize.img_normalize(
        s, normalize.global_max(s, cfg.quirks),
        normalize.global_min(s, cfg.quirks), cfg.quirks)


@partial(jax.jit, static_argnames=("cfg",))
def _phase_reduce(nrm, cfg):
    # f32 ladder, bf16 band storage (musica_forward's phase-3 bf16 note)
    bandpass, downs = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)
    return [b.astype(_storage(cfg)) for b in bandpass], downs


@partial(jax.jit, static_argnames=("cfg",))
def _phase_analysis(bandpass, cfg):
    sdevs = {i: stats.img_sdev(bandpass[i].astype(F32))
             for i in cfg.analysis_levels}
    return sdevs, stats.analysis_noise_hists(sdevs, cfg)[1]


@partial(jax.jit, static_argnames=("cfg",))
def _phase_apply(bandpass, sdevs, max_bins, cfg):
    sd = _storage(cfg)
    cnr = noise.img_cnr(sdevs[cfg.cnr_level], max_bins[cfg.cnr_level], cfg)
    exp_bandpass = []
    for i in range(cfg.pyramid_levels):
        lcf, hcf = cfg.contrast_factors[i]
        px, py = curves.contrast_curve(
            max_bins.get(i, jnp.zeros((), jnp.int32)), lcf, hcf, cfg)
        if i in sdevs:
            exp_bandpass.append(curves.contrast_curve_apply(
                bandpass[i].astype(F32), sdevs[i], px, py).astype(sd))
        else:
            exp_bandpass.append(
                (bandpass[i].astype(F32) * jnp.float32(hcf)).astype(sd))
    nr = {}
    for lvl in range(cfg.cnr_level):
        lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[lvl]
        nr[lvl] = noise.noise_reduction(exp_bandpass[lvl], cnr, lo_c,
                                        lo_f, hi_c, hi_f, cfg).astype(sd)
    return cnr, exp_bandpass, nr


@partial(jax.jit, static_argnames=("cfg",))
def _phase_expand(downs, exp_bandpass, nr, cfg):
    # f32 recon accumulation, bands upcast at the addition (see
    # musica_forward's phase-6 bf16 note)
    recon = downs[cfg.pyramid_levels - 1]
    for i in range(cfg.pyramid_levels):
        lvl = cfg.pyramid_levels - 1 - i
        low = pyramid.upsample_smooth(recon, exp_bandpass[lvl].shape[-1])
        band = nr[lvl] if lvl < cfg.cnr_level - 1 else exp_bandpass[lvl]
        recon = low + band.astype(F32)
    return recon


@partial(jax.jit, static_argnames=("cfg",))
def _phase_grad(recon, nrm, cnr, cfg):
    # same variant wiring as musica_forward's phase 7
    gi = recon * recon if cfg.grad_with_linear_image else recon
    extras = {}
    relevant = noise.img_relevant(nrm, cnr, cfg)
    if cfg.enable_clahe:
        from ..ops import clahe as clahe_ops
        extras["clahe_graded"] = clahe_ops.clahe_grade(recon, relevant, cfg)
    ghist = gradation.gradation_histogram(gi, relevant, cfg)
    gpx, gpy, _ = gradation.gradation_curve(ghist, cfg)
    m = cfg.out_margin
    return curves.curve_apply_u8_adaptive(
        gpx, gpy, gi[..., m:-m, m:-m].astype(F32)), extras


def timed_process(img_u16, cfg: Optional[MusicaConfig] = None,
                  want_extras: bool = False):
    """Per-phase timed execution, the analogue of MEASURE_PROCESS
    (src/vk_processing.cpp:2580-2596: one fence per phase, printf summary).

    Runs each phase as its own program, waited for with
    ``block_until_ready``, so -- exactly like the reference's extra fences
    -- the timed run is slower than the fused one, and a process's first
    call includes each phase's compilation.  The timed phases execute the
    CONFIGURED variant (enable_clahe / grad_with_linear_image), matching the
    reference where MEASURE_PROCESS fences the real pass whatever the
    compile-time variant.  Returns (out_u8, {phase: ms}); with
    ``want_extras`` also a dict of variant outputs (``clahe_graded`` when
    cfg.enable_clahe).
    """
    import time

    import numpy as np

    img = jnp.asarray(np.asarray(img_u16))
    cfg = cfg or MusicaConfig(image_size=img.shape[-1])
    times = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, cfg=cfg))
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    nrm = timed("norm", _phase_norm, img)
    bandpass, downs = timed("red", _phase_reduce, nrm)
    sdevs, max_bins = timed("anly", _phase_analysis, bandpass)
    cnr, exp_bandpass, nr = timed("aply", _phase_apply, bandpass, sdevs,
                                  max_bins)
    recon = timed("exp", _phase_expand, downs, exp_bandpass, nr)
    out, extras = timed("grad", _phase_grad, recon, nrm, cnr)
    times["tot"] = sum(times.values())
    out_np = np.asarray(out)
    if want_extras:
        return out_np, times, {k: np.asarray(v) for k, v in extras.items()}
    return out_np, times
