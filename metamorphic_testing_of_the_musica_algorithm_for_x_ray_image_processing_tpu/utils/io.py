"""Raw / BMP image IO.

Reproduces the reference's file formats:

* **Raw radiograph**: 256-byte header + ``size*size`` little-endian uint16
  (``test/standalone/main.cpp:57-75``, ``test/metamorphic_test/script.py:26-47``).
  The standalone CLI loads the row-major file into ``pixels[x*size + y]``,
  i.e. it processes the *transpose* of the file layout; ``load_raw`` exposes
  that via ``transpose=True`` (the CLI parity default).

* **8-bit single-channel BMP** output (written by stb_image_write in the
  reference, ``src/vk_processing.cpp:2636``).

A native C++ codec (``native/musica_io.cpp``, built with ``make -C native``)
accelerates batch loading; this module transparently falls back to NumPy
when the shared library has not been built.
"""

from __future__ import annotations

import ctypes
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np

RAW_HEADER_BYTES = 256

# ----------------------------------------------------------------------
# native codec (optional)
# ----------------------------------------------------------------------

_NATIVE: Optional[ctypes.CDLL] = None


def _load_native() -> Optional[ctypes.CDLL]:
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    here = Path(__file__).resolve().parents[2] / "native" / "libmusica_io.so"
    if not here.exists():
        return None
    try:
        lib = ctypes.CDLL(str(here))
        lib.musica_read_raw16.restype = ctypes.c_int
        lib.musica_read_raw16.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int]
        lib.musica_write_bmp8.restype = ctypes.c_int
        lib.musica_write_bmp8.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int]
        lib.musica_write_raw16.restype = ctypes.c_int
        lib.musica_write_raw16.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int]
        lib.musica_read_raw16_batch.restype = ctypes.c_int
        lib.musica_read_raw16_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int]
        _NATIVE = lib
        return lib
    except OSError:
        return None


def have_native_codec() -> bool:
    return _load_native() is not None


# ----------------------------------------------------------------------
# raw radiograph
# ----------------------------------------------------------------------

def load_raw(path: str | os.PathLike, size: int = 3072,
             transpose: bool = True) -> np.ndarray:
    """Load a 256-byte-header little-endian uint16 raw radiograph.

    ``transpose=True`` reproduces the standalone CLI's de-interleave
    (``test/standalone/main.cpp:67-75``: ``pixels[x*size+y]`` from a row-major
    scan), so the returned array's axis 0 is the shader's ``x``.
    """
    lib = _load_native()
    if lib is not None:
        out = np.empty((size, size), dtype=np.uint16)
        rc = lib.musica_read_raw16(
            str(path).encode(), size, RAW_HEADER_BYTES,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            1 if transpose else 0)
        if rc == 0:
            return out
        # fall through to numpy on error
    data = np.fromfile(path, dtype=np.uint8)
    expected = RAW_HEADER_BYTES + size * size * 2
    if data.size != expected:
        raise ValueError(
            f"raw file {path}: {data.size} bytes, expected {expected} "
            f"(256-byte header + {size}x{size} uint16)")
    img = data[RAW_HEADER_BYTES:].view("<u2").reshape(size, size)
    return img.T.copy() if transpose else img.copy()


def load_raw_batch(paths, size: int = 3072, transpose: bool = True,
                   n_threads: int = 0) -> np.ndarray:
    """Load many raws into one [B, size, size] array; uses the threaded
    native loader when available (the data-pipeline feed for batched
    processing)."""
    paths = [str(p) for p in paths]
    lib = _load_native()
    if lib is not None:
        out = np.empty((len(paths), size, size), dtype=np.uint16)
        rc = lib.musica_read_raw16_batch(
            "\n".join(paths).encode(), len(paths), size, RAW_HEADER_BYTES,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            1 if transpose else 0, n_threads)
        if rc == 0:
            return out
    return np.stack([load_raw(p, size, transpose) for p in paths])


def save_raw(path: str | os.PathLike, img_u16: np.ndarray,
             transpose: bool = False) -> None:
    """Write the 256-byte-header raw format (header zero-filled, matching the
    harness's ``save_image``, ``test/metamorphic_test/script.py:38-47``)."""
    img = np.asarray(img_u16, dtype="<u2")
    if transpose:
        img = img.T
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * RAW_HEADER_BYTES)
        f.write(np.ascontiguousarray(img).tobytes())


# ----------------------------------------------------------------------
# BMP (8-bit grayscale written as stb does: palette-indexed... stb writes
# 24-bit for comp=1? stb_write_bmp with comp=1 expands to 3 channels; we
# write a standard 8-bit palettized BMP which PIL reads back as 'L'.)
# ----------------------------------------------------------------------

def save_bmp8(path: str | os.PathLike, img_u8: np.ndarray) -> None:
    """Write a single-channel uint8 image as BMP.

    stb_image_write expands 1-channel data to 24-bit BGR
    (stb_image_write.h bmp path); we do the same so outputs are
    byte-compatible with the reference's BMPs when pixel values match.
    ``img_u8`` is indexed [x, y] (shader convention); BMP rows are written
    bottom-up with y as the row, x as the column -- matching how the
    reference's buffer (row-major in its own indexing) lands in the file.
    """
    lib = _load_native()
    img = np.asarray(img_u8, dtype=np.uint8)
    h, w = img.shape  # rows, cols as stored
    if lib is not None:
        rc = lib.musica_write_bmp8(
            str(path).encode(),
            np.ascontiguousarray(img).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w, h)
        if rc == 0:
            return
    _write_bmp24(path, np.repeat(img[..., None], 3, axis=-1))


def save_bmp_rgb(path: str | os.PathLike, img_rgb: np.ndarray) -> None:
    """Write an [h, w, 3] uint8 RGB image as 24-bit BMP (for the histogram /
    curve debug renders, reference: noise_hist_render.comp etc.)."""
    _write_bmp24(path, np.asarray(img_rgb, np.uint8))


def _write_bmp24(path, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    row_bytes = w * 3
    pad = (-row_bytes) % 4
    data_size = (row_bytes + pad) * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", 14 + 40 + data_size, 0, 0, 14 + 40,
        40, w, h, 1, 24, 0, data_size, 0, 0, 0, 0)
    body = bytearray()
    padding = b"\x00" * pad
    for row in range(h - 1, -1, -1):
        bgr = rgb[row][:, ::-1]  # BMP stores BGR
        body += np.ascontiguousarray(bgr).tobytes() + padding
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header)
        f.write(bytes(body))


def load_bmp(path: str | os.PathLike) -> np.ndarray:
    """Read a BMP back as a uint8 grayscale array [rows, cols] (uses PIL)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert("L"), dtype=np.uint8)


def load_bmp_rgb(path: str | os.PathLike) -> np.ndarray:
    """Read a BMP back as a uint8 RGB array [rows, cols, 3] (uses PIL)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert("RGB"), dtype=np.uint8)
