"""PyTorch port vs JAX package: Costas sync stencil and top-K candidates.

The stencil keeps the reference's term order, so float32 scores are
bit-identical to the JAX CPU stencil; the candidate search reproduces
lax.top_k's lowest-index tie order exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops.waterfall import (_block_spectrum,
                                               _block_waterfall_tf,
                                               waterfall_params)
from ft8_demodulator_tpu_torch.ops import sync as tsync

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)


def _grid(rng, osr=(2, 2)):
    """A JAX-computed time-major dB grid of noise at fs 2 kHz."""
    p = waterfall_params(FS, *osr)
    nf = p.num_frames(N)
    wave = jnp.asarray(rng.standard_normal(N).astype(np.float32))
    mag = np.array(_block_waterfall_tf(_block_spectrum(wave, p, nf), p,
                                       nf))
    return mag, p


def _grids(p, nf):
    return (jsync.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr),
            tsync.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr))


@pytest.mark.parametrize("grid_frames", [None, 130])
def test_sync_scores_tf_bit_identical(rng, grid_frames):
    """grid_frames None: the slot geometry (one padded grid).  130: a
    search grid shorter than the waterfall, so the main part needs no
    right padding and both packages score it in two pieces (pre-roll
    split)."""
    mag, p = _grid(rng)
    nf = grid_frames or mag.shape[0]
    jg, tg = _grids(p, nf)
    assert tuple(jg) == tuple(tg)
    main_cols = jg.num_times + jg.t_start
    split = main_cols + 78 * jg.time_osr - mag.shape[0] <= 0
    assert split == (grid_frames is not None)
    want = np.asarray(jsync.sync_scores_tf(jnp.asarray(mag), jg))
    got = tsync.sync_scores_tf(torch.as_tensor(mag), tg).numpy()
    assert got.shape == want.shape == (jg.num_times, jg.num_freqs)
    np.testing.assert_array_equal(got, want)
    # batched over a leading axis: the same values per slot
    flipped = mag[::-1].copy()
    both = tsync.sync_scores_tf(torch.as_tensor(np.stack([mag, flipped])),
                                tg).numpy()
    np.testing.assert_array_equal(both[0], want)
    np.testing.assert_array_equal(
        both[1], np.asarray(jsync.sync_scores_tf(jnp.asarray(flipped), jg)))


def test_cell_masks_equal_jax():
    p = waterfall_params(FS, 2, 2)
    jg, tg = _grids(p, p.num_frames(N))
    for got, want in zip(tsync._cell_masks(tg), jsync._cell_masks(jg)):
        np.testing.assert_array_equal(got, want)


def _assert_candidates_equal(scores, g_pair, k, min_score):
    jg, tg = g_pair
    want = [np.asarray(a) for a in jsync.find_candidates_tf(
        jnp.asarray(scores), jg, k, min_score)]
    got = [a.numpy() for a in tsync.find_candidates_tf(
        torch.as_tensor(scores), tg, k, min_score)]
    for name, g, w in zip(("abs_time", "abs_freq", "score", "valid"),
                          got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def test_find_candidates_on_sync_scores(rng):
    mag, p = _grid(rng)
    pair = _grids(p, mag.shape[0])
    scores = np.array(jsync.sync_scores_tf(jnp.asarray(mag), pair[0]))
    for k, min_score in ((20, 0.0), (10, 1.0), (20, -np.inf)):
        _assert_candidates_equal(scores, pair, k, min_score)


def test_find_candidates_exact_ties(rng):
    """Integer-valued scores: many exact ties, within and across rows."""
    p = waterfall_params(FS, 2, 2)
    pair = _grids(p, p.num_frames(N))
    g = pair[0]
    scores = rng.integers(0, 4, (g.num_times, g.num_freqs)) \
        .astype(np.float32)
    scores[rng.random(scores.shape) < 0.1] = -np.inf
    for k in (5, 20):
        _assert_candidates_equal(scores, pair, k, 2.0)


def test_find_candidates_fewer_finite_than_k(rng):
    p = waterfall_params(FS, 2, 2)
    pair = _grids(p, p.num_frames(N))
    g = pair[0]
    scores = np.full((g.num_times, g.num_freqs), -np.inf, np.float32)
    scores[rng.integers(0, g.num_times, 7), rng.integers(0, g.num_freqs, 7)] \
        = rng.uniform(5, 20, 7).astype(np.float32)
    scores[3, 4] = 1.0                      # finite but below min_score
    _, _, _, valid = _assert_candidates_equal(scores, pair, 20, 2.0)
    assert 0 < valid.sum() <= 7 and not valid[-1]


def test_find_candidates_narrow_grid(rng):
    """num_freqs <= K + 12: the flat top-K over the whole grid."""
    g = jsync.SearchGrid(2, 2, 40, -20, 30, 25)
    tg = tsync.SearchGrid(*g)
    scores = rng.standard_normal((30, 25)).astype(np.float32).round(1)
    _assert_candidates_equal(scores, (g, tg), 20, 0.0)


# --- the DEEP geometry: osr 4x4, K 40, min_score 1 -----------------------

def test_sync_scores_tf_bit_identical_deep_geometry(rng):
    mag, p = _grid(rng, (4, 4))
    jg, tg = _grids(p, mag.shape[0])
    assert tuple(jg) == tuple(tg)
    want = np.asarray(jsync.sync_scores_tf(jnp.asarray(mag), jg))
    got = tsync.sync_scores_tf(torch.as_tensor(mag), tg).numpy()
    assert got.shape == want.shape == (jg.num_times, jg.num_freqs)
    np.testing.assert_array_equal(got, want)


def test_find_candidates_deep_geometry(rng):
    """Top-40 above min_score 1 on the slot's sync scores, then on
    integer-valued scores with many exact ties."""
    mag, p = _grid(rng, (4, 4))
    pair = _grids(p, mag.shape[0])
    scores = np.array(jsync.sync_scores_tf(jnp.asarray(mag), pair[0]))
    _, _, _, valid = _assert_candidates_equal(scores, pair, 40, 1.0)
    assert valid.sum() > 0
    g = pair[0]
    ties = rng.integers(0, 4, (g.num_times, g.num_freqs)).astype(np.float32)
    ties[rng.random(ties.shape) < 0.1] = -np.inf
    _assert_candidates_equal(ties, pair, 40, 1.0)
