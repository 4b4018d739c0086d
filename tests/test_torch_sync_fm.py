"""PyTorch port vs JAX package: the frequency-major sync stencil and
candidate search, and the plain stencils against the two Pallas stencil
kernels (K5 time-major, K6 frequency-major) in interpret mode.

The port's plain stencils keep the reference's term order, so their scores
are bit-identical to the JAX stencils on the CPU; the Pallas kernels
regroup the terms into per-read coefficients, so they agree to float32
regrouping noise (|diff| <= 1e-4 on finite cells, the JAX tests' own
bound), with identical -inf masks and identical candidates.  The
``ops/sync_cuda.py`` wrappers take the plain versions for CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops.sync_pallas import sync_scores_pallas
from ft8_demodulator_tpu.ops.sync_pallas_tf import sync_scores_tf_pallas
from ft8_demodulator_tpu.ops.waterfall import waterfall_params, waterfall_real
from ft8_demodulator_tpu_torch.ops import sync as tsync
from ft8_demodulator_tpu_torch.ops import sync_cuda as tsc
from ft8_demodulator_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
# the Pallas kernels' regrouped sums against the stencil (their tests' bound)
PALLAS_ATOL = 1e-4


def _mag(seed, osr=(2, 2), batch=None, fs=FS):
    """A JAX-computed frequency-major dB grid (F, T) of noise."""
    p = waterfall_params(fs, *osr)
    n = int(fs * 15)
    nf = p.num_frames(n)
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    wave = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    return np.array(waterfall_real(wave, p, nf)), p


def _grids(p, nf):
    g = jsync.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    return g, tsync.SearchGrid(*g)


@pytest.mark.parametrize("osr,grid_frames", [((2, 2), None), ((2, 2), 130),
                                             ((4, 4), None), ((4, 4), 260)])
def test_sync_scores_bit_identical(osr, grid_frames):
    """grid_frames None: the slot geometry, whose main part needs a right
    pad (one padded grid).  Shorter search grids: the main part needs no
    right pad, and both packages score it in two pieces (pre-roll split).
    XLA evaluates the division by the count as a reciprocal multiply in
    this layout too: the port's reciprocal-multiply scores equal JAX's."""
    mag, p = _mag(5, osr)
    jg, tg = _grids(p, grid_frames or mag.shape[1])
    main_cols = jg.num_times + jg.t_start
    split = main_cols + 78 * jg.time_osr - mag.shape[1] <= 0
    assert split == (grid_frames is not None)
    want = np.asarray(jsync.sync_scores(jnp.asarray(mag), jg))
    got = tsync.sync_scores(torch.as_tensor(mag), tg).numpy()
    assert got.shape == want.shape == (jg.num_freqs, jg.num_times)
    np.testing.assert_array_equal(got, want)
    # the same values through the time-major stencil on the transpose, and
    # through the CPU route of the kernel wrapper
    tf = tsync.sync_scores_tf(torch.as_tensor(mag.T.copy()), tg).numpy()
    np.testing.assert_array_equal(tf.T, want)
    np.testing.assert_array_equal(
        tsc.sync_scores_kernel(torch.as_tensor(mag), tg).numpy(), want)


def test_sync_scores_batched_and_cropped():
    """Leading batch axis, and a frequency + time crop (a strided view)."""
    mag, p = _mag(6, batch=2)
    jg, tg = _grids(p, mag.shape[-1])
    got = tsync.sync_scores(torch.as_tensor(mag), tg).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jsync.sync_scores(jnp.asarray(mag[b]), jg)))
    crop = mag[0, 40:180, 10:170]
    jc = jsync.search_grid(*crop.shape, p.time_osr, p.freq_osr)
    tc = tsync.SearchGrid(*jc)
    view = torch.as_tensor(mag[0])[40:180, 10:170]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        tsc.sync_scores_kernel(view, tc).numpy(),
        np.asarray(jsync.sync_scores(jnp.asarray(crop), jc)))


def _assert_candidates_equal(scores, pair, k, min_score):
    jg, tg = pair
    want = [np.asarray(a) for a in jsync.find_candidates(
        jnp.asarray(scores), jg, k, min_score)]
    got = [a.numpy() for a in tsync.find_candidates(
        torch.as_tensor(np.array(scores)), tg, k, min_score)]
    for name, g, w in zip(("abs_time", "abs_freq", "score", "valid"),
                          got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


@pytest.mark.parametrize("osr,k,min_score", [((2, 2), 20, 10.0),
                                             ((2, 2), 20, 0.0),
                                             ((4, 4), 40, 1.0)])
def test_find_candidates_on_sync_scores(osr, k, min_score):
    """The screen branch (num_freqs > K + 12): rows by frequency, flat
    index f * num_times + t."""
    mag, p = _mag(7, osr)
    pair = _grids(p, mag.shape[1])
    scores = np.array(jsync.sync_scores(jnp.asarray(mag), pair[0]))
    assert scores.shape[0] > k + 12
    _assert_candidates_equal(scores, pair, k, min_score)


@pytest.mark.parametrize("k", [5, 20, 40])
def test_find_candidates_exact_ties(rng, k):
    """Integer-valued scores: many exact ties, within and across rows."""
    p = waterfall_params(FS, 2, 2)
    pair = _grids(p, p.num_frames(N))
    g = pair[0]
    scores = rng.integers(0, 4, (g.num_freqs, g.num_times)) \
        .astype(np.float32)
    scores[rng.random(scores.shape) < 0.1] = -np.inf
    _assert_candidates_equal(scores, pair, k, 2.0)


def test_find_candidates_narrow_and_sparse(rng):
    """num_freqs <= K + 12 (the flat branch), and fewer finite cells than
    K."""
    g = jsync.SearchGrid(2, 2, 40, -20, 30, 25)
    scores = rng.standard_normal((25, 30)).astype(np.float32).round(1)
    _assert_candidates_equal(scores, (g, tsync.SearchGrid(*g)), 20, 0.0)
    p = waterfall_params(FS, 2, 2)
    pair = _grids(p, p.num_frames(N))
    sparse = np.full((pair[0].num_freqs, pair[0].num_times), -np.inf,
                     np.float32)
    sparse[rng.integers(0, sparse.shape[0], 7),
           rng.integers(0, sparse.shape[1], 7)] = rng.uniform(5, 20, 7)
    _, _, _, valid = _assert_candidates_equal(sparse, pair, 20, 2.0)
    assert 0 < valid.sum() <= 7 and not valid[-1]


def test_sync_scores_on_integer_grid_with_ties(rng):
    """An integer-valued dB grid: scores with many exact ties, bit-equal,
    and the same candidates."""
    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    mag = rng.integers(-3, 4, (p.num_freq_bins, nf)).astype(np.float32)
    pair = _grids(p, nf)
    want = np.asarray(jsync.sync_scores(jnp.asarray(mag), pair[0]))
    got = tsync.sync_scores(torch.as_tensor(mag), pair[1]).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[np.isfinite(got)])) < got.size // 10
    _assert_candidates_equal(want, pair, 20, 0.5)


# --- the plain stencils against the Pallas kernels (interpret mode) -------

def _assert_close_to_kernel(got, kernel_out):
    finite = np.isfinite(got)
    assert (finite == np.isfinite(kernel_out)).all()
    assert (np.isneginf(got) == np.isneginf(kernel_out)).all()
    assert np.abs(np.where(finite, got - kernel_out, 0.0)).max() \
        <= PALLAS_ATOL


def test_plain_time_major_matches_k5_interpret():
    """The port's plain time-major stencil against sync_scores_tf_pallas
    (K5) sliced to the real frequency extent, batch 3; identical
    candidates through find_candidates_tf."""
    mag, p = _mag(8, batch=3)
    mag_tf = np.ascontiguousarray(np.swapaxes(mag, -1, -2))
    jg, tg = _grids(p, mag_tf.shape[1])
    kern = np.asarray(sync_scores_tf_pallas(jnp.asarray(mag_tf), jg,
                                            interpret=True))
    assert np.isneginf(kern[..., jg.num_freqs:]).all()
    kern = kern[..., : jg.num_freqs]
    got = tsync.sync_scores_tf(torch.as_tensor(mag_tf), tg).numpy()
    _assert_close_to_kernel(got, kern)
    for b in range(3):
        want = [np.asarray(a) for a in jsync.find_candidates_tf(
            jnp.asarray(kern[b]), jg, 20, 10.0)]
        mine = [a.numpy() for a in tsync.find_candidates_tf(
            torch.as_tensor(got[b]), tg, 20, 10.0)]
        for w, m in zip(want[:2] + want[3:], mine[:2] + mine[3:]):
            np.testing.assert_array_equal(m, w)


def test_plain_freq_major_matches_k6_interpret():
    """The port's plain frequency-major stencil against sync_scores_pallas
    (K6), batch 2; identical candidates through find_candidates."""
    mag, p = _mag(9, batch=2)
    jg, tg = _grids(p, mag.shape[-1])
    kern = np.asarray(sync_scores_pallas(jnp.asarray(mag), jg,
                                         interpret=True))
    got = tsync.sync_scores(torch.as_tensor(mag), tg).numpy()
    assert kern.shape == got.shape == (2, jg.num_freqs, jg.num_times)
    _assert_close_to_kernel(got, kern)
    for b in range(2):
        want = [np.asarray(a) for a in jsync.find_candidates(
            jnp.asarray(kern[b]), jg, 20, 10.0)]
        mine = [a.numpy() for a in tsync.find_candidates(
            torch.as_tensor(got[b]), tg, 20, 10.0)]
        for w, m in zip(want[:2] + want[3:], mine[:2] + mine[3:]):
            np.testing.assert_array_equal(m, w)


def test_kernel_wrappers_on_cpu_take_plain_and_check_shapes():
    """The wrappers' CPU route is the plain version and counts no launch;
    a grid narrower than num_freqs + 7 freq_osr is refused."""
    mag, p = _mag(10)
    _, tg = _grids(p, mag.shape[1])
    before = (counters().get("k6.launches", 0),
              counters().get("k5.launches", 0))
    mag_t = torch.as_tensor(mag)
    torch.testing.assert_close(tsc.sync_scores_kernel(mag_t, tg),
                               tsync.sync_scores(mag_t, tg), rtol=0, atol=0)
    torch.testing.assert_close(
        tsc.sync_scores_tf_kernel(mag_t.T, tg),
        tsync.sync_scores_tf(mag_t.T, tg), rtol=0, atol=0)
    assert (counters().get("k6.launches", 0),
            counters().get("k5.launches", 0)) == before
    with pytest.raises(ValueError, match="bins"):
        tsc.sync_scores_kernel(mag_t[:-1], tg)
    with pytest.raises(ValueError, match="float32"):
        tsc.sync_scores_tf_kernel(mag_t.T.double(), tg)
