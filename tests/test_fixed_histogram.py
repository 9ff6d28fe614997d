"""The one histogram implementation (ops.stats.fixed_histogram): exact
integer counts, equal to np.bincount, for every bin count the pipeline
uses and across the matrix-product chunk boundaries."""

import numpy as np
import pytest

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import stats


def _bincount(b, w, n_bins):
    keep = (b >= 0) & (b < n_bins)
    return np.bincount(b[keep], weights=w[keep], minlength=n_bins).astype(np.int64)


@pytest.mark.parametrize("n_bins", [2048, 1024, 256, 50])
def test_fixed_histogram_matches_bincount(rng, n_bins):
    """Noise (2048), gradation (1024), metric/CLAHE (256) and a bin count
    that does not factor evenly (50), with integer weights 0..100."""
    n = 40000
    b = rng.integers(0, n_bins, n).astype(np.int32)
    w = rng.integers(0, 101, n).astype(np.float32)
    got = np.asarray(stats.fixed_histogram(jnp.asarray(b), jnp.asarray(w),
                                           n_bins))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _bincount(b, w, n_bins))


@pytest.mark.parametrize("n", [100, stats._HIST_CHUNK, stats._HIST_CHUNK + 77])
def test_fixed_histogram_chunk_padding(rng, n):
    """Inputs shorter than, equal to and just past one chunk: the zero-
    weight padding must drop out of the counts."""
    n_bins = 2048
    b = rng.integers(0, n_bins, n).astype(np.int32)
    w = (rng.random(n) < 0.8).astype(np.float32)
    got = np.asarray(stats.fixed_histogram(jnp.asarray(b), jnp.asarray(w),
                                           n_bins))
    np.testing.assert_array_equal(got, _bincount(b, w, n_bins))


def test_bf16_weight_exactness():
    # integer weights up to 100 (gradation) must be exact through bf16
    n_bins = 1024
    b = jnp.asarray(np.full(5000, 7, np.int32))
    w = jnp.asarray(np.full(5000, 100.0, np.float32))
    h = np.asarray(stats.fixed_histogram(b, w, n_bins))
    assert h[7] == 500000
    assert h.sum() == 500000


def test_full_chunk_at_max_weight_is_exact():
    """The exactness bound: one full chunk of weight-128 entries in one bin
    sums to exactly 2^24 in f32, and a second chunk carries on in int32."""
    n = 2 * stats._HIST_CHUNK
    b = jnp.zeros((n,), jnp.int32)
    w = jnp.full((n,), 128.0, jnp.float32)
    h = np.asarray(stats.fixed_histogram(b, w, 256))
    assert int(h[0]) == 2 * 2 ** 24
    assert int(h[1:].sum()) == 0


def test_out_of_range_bins_dropped(rng):
    """Bins below 0 or at/above n_bins carry no count, whatever their
    weight (the reference's out-of-range atomics are dropped)."""
    b = rng.integers(-40, 90, 20000).astype(np.int32)
    w = rng.integers(0, 101, 20000).astype(np.float32)
    got = np.asarray(stats.fixed_histogram(jnp.asarray(b), jnp.asarray(w), 50))
    np.testing.assert_array_equal(got, _bincount(b, w, 50))


@pytest.mark.parametrize("n_bins", [2048, 1024, 256, 50, 2000])
def test_factor_split_covers_bins(n_bins):
    c, f, padded = stats._factor(n_bins)
    assert c * f == padded >= n_bins
    assert padded - n_bins < 32
