"""Raw/BMP IO: native codec vs NumPy fallback parity, format round-trips."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as uio

NATIVE = Path(__file__).resolve().parents[1] / "native"


def test_raw_roundtrip(tmp_path, rng):
    img = rng.integers(0, 65536, (64, 64)).astype(np.uint16)
    p = tmp_path / "x.raw"
    uio.save_raw(p, img)
    back = uio.load_raw(p, 64, transpose=False)
    np.testing.assert_array_equal(back, img)
    # transpose mode reproduces the CLI's pixels[x*n+y] de-interleave
    back_t = uio.load_raw(p, 64, transpose=True)
    np.testing.assert_array_equal(back_t, img.T)


def test_raw_wrong_size_raises(tmp_path):
    p = tmp_path / "bad.raw"
    p.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError):
        uio.load_raw(p, 64)


def test_bmp_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, (48, 32)).astype(np.uint8)
    p = tmp_path / "x.bmp"
    uio.save_bmp8(p, img)
    back = uio.load_bmp(p)
    np.testing.assert_array_equal(back, img)


@pytest.fixture(scope="module")
def native_codec():
    """Build the codec from native/musica_io.cpp (the shared library is not
    committed; `make -C native` is the one build command)."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ toolchain to build native/")
    subprocess.run(["make", "-s", "-C", str(NATIVE)], check=True)
    assert uio.have_native_codec()


def test_native_matches_numpy(native_codec, tmp_path, rng):
    img = rng.integers(0, 65536, (96, 96)).astype(np.uint16)
    p = tmp_path / "x.raw"
    uio.save_raw(p, img)
    # force the numpy path by bypassing the codec
    data = np.fromfile(p, dtype=np.uint8)
    ref = data[uio.RAW_HEADER_BYTES:].view("<u2").reshape(96, 96).T
    nat = uio.load_raw(p, 96, transpose=True)
    np.testing.assert_array_equal(nat, ref)


def test_native_batch_loader(native_codec, tmp_path, rng):
    imgs = [rng.integers(0, 65536, (32, 32)).astype(np.uint16) for _ in range(5)]
    paths = []
    for i, im in enumerate(imgs):
        p = tmp_path / f"{i}.raw"
        uio.save_raw(p, im)
        paths.append(p)
    batch = uio.load_raw_batch(paths, 32, transpose=False, n_threads=2)
    np.testing.assert_array_equal(batch, np.stack(imgs))


def test_native_bmp_matches_python(native_codec, tmp_path, rng):
    img = rng.integers(0, 256, (20, 36)).astype(np.uint8)
    p1 = tmp_path / "nat.bmp"
    uio.save_bmp8(p1, img)  # native codec path
    # python fallback: call internals with codec disabled
    import metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils.io as m
    saved = m._NATIVE
    try:
        m._NATIVE = None

        def _no_native():
            return None
        orig = m._load_native
        m._load_native = _no_native
        p2 = tmp_path / "py.bmp"
        uio.save_bmp8(p2, img)
    finally:
        m._NATIVE = saved
        m._load_native = orig
    assert p1.read_bytes() == p2.read_bytes()
