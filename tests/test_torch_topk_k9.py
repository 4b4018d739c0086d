"""K9's algorithm on the CPU: a numpy model of the kernel's selection
(``tests/_torch_k9_model.py``: ordered keys, row maxima, radix select,
compaction in index order, the composites' sort) against the port's plain
candidate search (``ops/sync.py`` ``find_candidates_tf`` /
``find_candidates``) on the cases of ``test_torch_sync.py``, tie-heavy
grids on both routes (screened and flat) and both geometries (2x2 K 20,
4x4 K 40), strided frequency-major crops, a large K and a grid with
zeros of both signs; the plain route against the JAX package on those cases; and
the wrapper's refusals, which need no card.  The kernel itself runs in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops.waterfall import (_block_spectrum,
                                               _block_waterfall_tf,
                                               waterfall_params)
from ft8_demodulator_tpu_torch.ops import sync as tsync
from ft8_demodulator_tpu_torch.ops import topk_cuda as ttk
from ft8_demodulator_tpu_torch.utils.profiling import counters

import _torch_k9_model as k9

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
NAMES = ("abs_time", "abs_freq", "score", "valid")


def _sync_grid(rng, osr):
    """JAX's sync scores (T, F) of a noise slot at 2 kHz, and its grid."""
    p = waterfall_params(FS, *osr)
    nf = p.num_frames(N)
    wave = jnp.asarray(rng.standard_normal(N).astype(np.float32))
    mag = _block_waterfall_tf(_block_spectrum(wave, p, nf), p, nf)
    g = jsync.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    return np.array(jsync.sync_scores_tf(mag, g)), g


def _ties(rng, shape, levels=4):
    """Integer-valued scores with 10 % -inf: exact ties within and across
    rows."""
    s = rng.integers(0, levels, shape).astype(np.float32)
    s[rng.random(shape) < 0.1] = -np.inf
    return s


def _case(name, rng):
    """(scores (T, F), search grid, K, min_score) of a named case."""
    if name.startswith("sync"):
        osr = (4, 4) if "4x4" in name else (2, 2)
        scores, g = _sync_grid(rng, osr)
        k, min_score = {"sync 2x2 K20": (20, 0.0), "sync 2x2 K10": (10, 1.0),
                        "sync 2x2 K20 -inf": (20, -np.inf),
                        "sync 4x4 K40": (40, 1.0)}[name]
        return scores, g, k, min_score
    if name.startswith("ties"):
        osr, k = ((4, 4), 40) if "4x4" in name else ((2, 2), 20)
        p = waterfall_params(FS, *osr)
        g = jsync.search_grid(p.num_freq_bins, p.num_frames(N), *osr)
        levels = 16 if "16 levels" in name else 4
        return _ties(rng, (g.num_times, g.num_freqs), levels), g, k, 1.0
    if name == "fewer finite than K":
        p = waterfall_params(FS, 2, 2)
        g = jsync.search_grid(p.num_freq_bins, p.num_frames(N), 2, 2)
        s = np.full((g.num_times, g.num_freqs), -np.inf, np.float32)
        s[rng.integers(0, g.num_times, 7), rng.integers(0, g.num_freqs, 7)] \
            = rng.uniform(5, 20, 7).astype(np.float32)
        s[3, 4] = 1.0                        # finite but below min_score
        return s, g, 20, 2.0
    if name == "flat":
        g = jsync.SearchGrid(2, 2, 40, -20, 30, 25)
        return rng.standard_normal((30, 25)).astype(np.float32).round(1), \
            g, 20, 0.0
    if name == "flat ties":
        g = jsync.SearchGrid(4, 4, 40, -40, 44, 52)
        return _ties(rng, (44, 52)), g, 40, 1.0
    if name == "flat, fewer cells than K":
        g = jsync.SearchGrid(2, 2, 10, -4, 3, 5)
        return _ties(rng, (3, 5)), g, 20, 1.0
    if name == "large K screened":
        g = jsync.SearchGrid(4, 4, 60, -40, 40, 1200)
        return _ties(rng, (40, 1200), 50), g, 1024, 1.0
    if name == "large K flat":
        g = jsync.SearchGrid(4, 4, 60, -40, 40, 600)
        return _ties(rng, (40, 600), 50), g, 1024, 1.0
    if name == "K 1":
        p = waterfall_params(FS, 2, 2)
        g = jsync.search_grid(p.num_freq_bins, p.num_frames(N), 2, 2)
        return _ties(rng, (g.num_times, g.num_freqs)), g, 1, 1.0
    raise KeyError(name)


CASES = ["sync 2x2 K20", "sync 2x2 K10", "sync 2x2 K20 -inf", "sync 4x4 K40",
         "ties 2x2", "ties 4x4", "ties 2x2 16 levels", "fewer finite than K", "flat", "flat ties",
         "flat, fewer cells than K", "large K screened", "large K flat",
         "K 1"]


def _plain(scores, g, k, min_score):
    return [a.numpy() for a in tsync.find_candidates_tf(
        torch.as_tensor(scores), tsync.SearchGrid(*g), k, min_score)]


def _assert_equal(got, want, what):
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_route_and_jax(rng, case):
    """The model equals the plain route bit for bit, and the plain route
    equals JAX's find_candidates_tf (lax.top_k's order; JAX refuses a K
    beyond the cells), on one slot and on a lead of two (the grid and its
    time reversal)."""
    scores, g, k, min_score = _case(case, rng)
    screened = scores.shape[1] > k + k9.ROW_SLACK
    assert screened == case.startswith(("sync", "ties", "fewer", "large K s",
                                        "K 1"))
    plain = _plain(scores, g, k, min_score)
    _assert_equal(k9.select(scores, g.t_start, k, min_score), plain, "model")
    if case == "flat, fewer cells than K":
        # lax.top_k takes no K beyond the cells; the port returns them all
        assert len(plain[0]) == scores.size < k
        with pytest.raises(ValueError, match="top_k"):
            jsync.find_candidates_tf(jnp.asarray(scores), g, k, min_score)
    else:
        want = [np.asarray(a) for a in jsync.find_candidates_tf(
            jnp.asarray(scores), g, k, min_score)]
        _assert_equal(plain, want, "jax")
    both = np.stack([scores, scores[::-1].copy()])
    got = k9.select(both, g.t_start, k, min_score)
    _assert_equal([a[0] for a in got], plain, "lead 0")
    _assert_equal([a[1] for a in got],
                  _plain(both[1], g, k, min_score), "lead 1")
    _assert_equal(got, _plain(both, g, k, min_score), "lead")


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)], ids=["2x2", "4x4"])
def test_model_matches_frequency_major_crop(rng, osr):
    """find_candidates on a frequency-major crop (a band of rows and a
    span of start times, not contiguous) is the time-major search on its
    transposed view: the model on the crop's values equals it, and JAX's
    find_candidates on the same values."""
    k = 40 if osr == (4, 4) else 20
    full = np.ascontiguousarray(_ties(rng, (700, 260)))       # (F, T)
    crop = torch.as_tensor(full)[100: 600, 30: 230]
    assert not crop.is_contiguous()
    g = jsync.SearchGrid(osr[0], osr[1], 120, -10 * osr[0], 200, 500)
    got = [a.numpy() for a in tsync.find_candidates(
        crop, tsync.SearchGrid(*g), k, 1.0)]
    _assert_equal(k9.select(crop.numpy().T, g.t_start, k, 1.0), got,
                  "model")
    want = [np.asarray(a) for a in jsync.find_candidates(
        jnp.asarray(crop.numpy()), g, k, 1.0)]
    _assert_equal(got, want, "jax")


def test_model_ties_signed_zeros_as_torch_sort_does(rng):
    """-0.0 and +0.0 are one key, in index order, as torch.sort holds them
    (on the CPU and on the card): the model equals the plain route on a
    grid of -2, -1 and zeros of both signs, in rows too, and keeps each
    winner's zero as the grid has it."""
    g = jsync.SearchGrid(2, 2, 60, -20, 40, 200)
    s = rng.integers(-2, 1, (40, 200)).astype(np.float32)    # -2, -1, 0
    s = np.where((s == 0) & (rng.random(s.shape) < 0.5), np.float32(-0.0),
                 s)
    s[rng.random(s.shape) < 0.1] = -np.inf
    for k, min_score in ((20, -1.0), (40, -np.inf), (20, 0.0)):
        got = k9.select(s, g.t_start, k, min_score)
        _assert_equal(got, _plain(s, g, k, min_score), f"K {k}")
        zeros = got[2][got[2] == 0]
        assert np.signbit(zeros).any() and not np.signbit(zeros).all()
    zeros = k9.select(np.array([[-0.0, 0.0]], np.float32), 0, 2, -1.0)
    assert zeros[1].tolist() == [0, 1]
    assert np.signbit(zeros[2]).tolist() == [True, False]


def test_radix_select_stops_early_and_takes_ties_by_index():
    """The threshold search stops as soon as the keys at the prefix are
    those still wanted, and the ties at the threshold go by index."""
    keys = k9.ordered(np.array([3, 1, 2, 2, 2, 0, 2], np.float32))
    prefix, mask, need = k9.radix_select(keys, 3)
    assert mask == 0xFFFFFFFF and need == 2
    assert k9.top(keys, 3).tolist() == [0, 2, 3]
    prefix, mask, need = k9.radix_select(keys, 7)
    assert (prefix, mask, need) == (0, 0, 7)
    assert k9.top(keys, 7).tolist() == [0, 2, 3, 4, 6, 1, 5]


def test_cpu_tensors_take_the_plain_route(rng):
    """A CPU tensor never reaches the kernel: no k9 launch is counted."""
    scores, g, k, min_score = _case("ties 2x2", rng)
    before = counters().get("k9.launches", 0)
    tsync.find_candidates_tf(torch.as_tensor(scores), tsync.SearchGrid(*g),
                             k, min_score)
    assert counters().get("k9.launches", 0) == before


def _refusal(case):
    grid = torch.zeros(2, 30, 40)
    args = dict(num_times=30, t_start=-4, max_candidates=20, min_score=1.0)
    if case == "1-D scores":
        grid = torch.zeros(40)
    elif case == "float64 scores":
        grid = grid.double()
    elif case == "int32 scores":
        grid = grid.int()
    elif case == "K 0":
        args["max_candidates"] = 0
    elif case == "K over 1,024":
        args["max_candidates"] = 1025
    elif case == "start times mismatch":
        args["num_times"] = 31
    elif case == "lead not one stride":
        grid = torch.zeros(3, 4, 30, 40).transpose(0, 1)
    elif case == "screened over 32,768 frequencies":
        grid = torch.zeros(1, 1).expand(2, 40000)
        args["num_times"] = 2
    elif case == "2^31 cells":
        grid = torch.zeros(1, 1).expand(2 ** 21, 1024)
        args.update(num_times=2 ** 21, max_candidates=1024)
    elif case == "t_start beyond int32":
        args["t_start"] = 2 ** 31
    return grid, args


REFUSALS = ["1-D scores", "float64 scores", "int32 scores", "K 0",
            "K over 1,024", "start times mismatch", "lead not one stride",
            "screened over 32,768 frequencies", "2^31 cells",
            "t_start beyond int32", "cpu tensors"]


@pytest.mark.parametrize("case", REFUSALS)
def test_wrapper_refuses(case):
    """The wrapper's checks run before it looks for a card: a bad shape,
    type or limit, and on valid arguments a CPU tensor, raise
    ValueError."""
    grid, args = _refusal(case)
    match = "no kernel for device cpu" if case == "cpu tensors" else None
    with pytest.raises(ValueError, match=match):
        ttk.topk_kernel(grid, **args)


def test_lead_that_steps_at_one_stride_is_taken():
    """A lead of several dimensions that step at one stride, and size-1
    dimensions at any stride, pass the lead check (then the CPU device
    refuses)."""
    grid = torch.zeros(6, 30, 40)[::2].reshape(3, 1, 30, 40)
    assert ttk._lead_stride(grid) == 2 * 30 * 40
    assert ttk._lead_stride(torch.zeros(2, 3, 30, 40)) == 30 * 40
    assert ttk._lead_stride(torch.zeros(30, 40)) == 0
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ttk.topk_kernel(grid, 30, 0, 20, 1.0)


def test_bound_counts_each_byte_once():
    """The grid's float32 scores read once, 13 bytes written a candidate."""
    assert ttk.topk_bound(16, 88, 1906, 20) == pytest.approx(
        16 * (88 * 1906 * 4 + 20 * 13) / 3.35e12)


@pytest.mark.parametrize("case", ["sync 2x2 K20", "sync 4x4 K40",
                                  "ties 2x2 16 levels", "ties 2x2",
                                  "ties 4x4"])
def test_bound_from_row_maxima_finds_the_same_cells(rng, case):
    """The K-th largest row maximum bounds the K winners from below: the
    cells that reach it, sorted whole, begin with the radix select's
    winners.  Noise leaves a few dozen such cells (one warp's sort), a
    grid of 16 levels a few hundred (the block's sort), one of 4 levels
    more than 512 (the radix select)."""
    scores, g, k, min_score = _case(case, rng)
    keys = k9.ordered(k9.masked(scores, min_score))
    row_max = keys.max(axis=0)
    rows = k9.top(row_max, k + k9.ROW_SLACK)
    cells = keys[:, rows].T.reshape(-1)
    bound = row_max[rows[k - 1]]
    above = np.flatnonzero(cells >= bound)
    np.testing.assert_array_equal(k9.by_composite(cells, above)[:k],
                                  k9.top(cells, k))
    _, served = k9.top_above(cells, k, bound)
    assert served == (len(above) <= k9.BOUND_CAP)
    if case.startswith("sync"):
        assert len(above) <= 64, len(above)
    elif "16 levels" in case:
        assert 64 < len(above) <= k9.BOUND_CAP, len(above)
    else:
        assert not served, len(above)
