"""The sync stencil kernel's plane arithmetic against the JAX stencil.

The CUDA stencil (``csrc/sync_stencil.cu``) sums difference planes in
place of the plain order's terms: D = H(x) - H(x - phi) with H(x) =
g[x] - g[x + phi] for the frequency pair, and P(r) = g[r] - g[r - tau] for
the previous symbol (next symbol: total - P(r + tau)).
``ops.sync_cuda.sync_scores_tf_planes`` is that arithmetic in plain
PyTorch; here it must equal JAX's ``ops.sync.sync_scores_tf`` and, on the
transposed view, ``sync_scores`` bit for bit, and the two identities are
checked on float32 pairs, signed zeros included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops.waterfall import waterfall_params, waterfall_real
from ft8_demodulator_tpu_torch.ops import sync_cuda as tsc
from ft8_demodulator_tpu_torch.ops.sync import SearchGrid

torch.set_num_threads(2)

# a 15-s slot's frames at osr tau (the search grid's num_times is 44 tau)
SLOT_FRAMES = {1: 93, 2: 186, 4: 372}


def _grid(kind: str, seed: int, shape) -> np.ndarray:
    """A time-major f32 grid: dB-like noise, or small integers with many
    ties and exact zeros (so that cur == neighbour gives signed zeros)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return (-40.0 + 6.0 * rng.standard_normal(shape)).astype(np.float32)
    grid = rng.integers(-2, 3, shape).astype(np.float32)
    grid[rng.random(shape) < 0.2] = -0.0
    return grid


def _assert_planes_equal_jax(mag_tf: np.ndarray, jg, view=None) -> None:
    """Planes on ``view`` (default: the tensor of ``mag_tf``) == JAX
    sync_scores_tf on ``mag_tf`` bit for bit, and the frequency-major
    form == JAX sync_scores on the transpose."""
    def per_slot(fn, grids):          # the JAX stencils take one 2-D grid
        flat = grids.reshape(-1, *grids.shape[-2:])
        out = np.stack([np.asarray(fn(jnp.asarray(x), jg)) for x in flat])
        return out.reshape(*grids.shape[:-2], *out.shape[-2:])

    want = per_slot(jsync.sync_scores_tf, mag_tf)
    tg = SearchGrid(*jg)
    src = torch.as_tensor(mag_tf) if view is None else view
    got = tsc.sync_scores_tf_planes(src, tg).numpy()
    assert got.shape == want.shape == (*mag_tf.shape[:-2], jg.num_times,
                                       jg.num_freqs)
    assert np.isneginf(got).any() == np.isneginf(want).any()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    mag = np.ascontiguousarray(np.swapaxes(mag_tf, -1, -2))
    want_fm = per_slot(jsync.sync_scores, mag)
    got_fm = tsc.sync_scores_tf_planes(
        src.transpose(-1, -2).contiguous().transpose(-1, -2), tg)
    np.testing.assert_array_equal(
        got_fm.transpose(-1, -2).numpy().view(np.uint32),
        want_fm.view(np.uint32))


@pytest.mark.parametrize("osr,kind,bins", [((2, 2), "noise", 40),
                                           ((4, 4), "noise", 60),
                                           ((2, 2), "integer", 40),
                                           ((4, 4), "integer", 44),
                                           ((1, 3), "integer", 30)])
def test_planes_equal_jax_on_slot_grids(osr, kind, bins):
    """Slot geometry (pre-roll, right pad) at a small frequency width,
    batch 2."""
    tau, phi = osr
    frames = SLOT_FRAMES[tau]
    mag_tf = _grid(kind, 10 * tau + phi, (2, frames, bins))
    jg = jsync.search_grid(bins, frames, tau, phi)
    assert jg.num_times == 44 * tau and jg.num_freqs == bins - 7 * phi
    _assert_planes_equal_jax(mag_tf, jg)


def test_planes_equal_jax_at_2khz():
    """A JAX-computed dB waterfall of noise at 2 kHz, osr 2x2."""
    p = waterfall_params(2000.0, 2, 2)
    n = 30000
    nf = p.num_frames(n)
    wave = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    mag = np.asarray(waterfall_real(jnp.asarray(wave), p, nf))    # (F, T)
    mag_tf = np.ascontiguousarray(mag.T)
    _assert_planes_equal_jax(
        mag_tf, jsync.search_grid(p.num_freq_bins, nf, 2, 2))


@pytest.mark.parametrize("grid_frames", [130, 260, 400])
def test_planes_equal_jax_on_short_and_long_grids(grid_frames):
    """A search grid from another frame count than the grid has: 130 (the
    pre-roll split geometry of the plain stencils), and 260 / 400 frames,
    more than the grid's 186 (num_blocks * tau > num_frames: reads past
    the grid's end are zeros)."""
    mag_tf = _grid("noise", grid_frames, (186, 36))
    jg = jsync.search_grid(36, grid_frames, 2, 2)
    assert (jg.num_blocks * 2 > 186) == (grid_frames > 186)
    _assert_planes_equal_jax(mag_tf, jg)


def test_planes_equal_jax_on_a_cropped_view():
    """A frequency + time crop of a frequency-major grid, read as a strided
    time-major view."""
    full = _grid("integer", 5, (96, 260))                        # (F, T)
    crop = torch.as_tensor(full)[20:80, 30:230]
    view = crop.transpose(0, 1)                                  # (T, F)
    assert not view.is_contiguous()
    jg = jsync.search_grid(60, 200, 2, 2)
    _assert_planes_equal_jax(np.ascontiguousarray(full[20:80, 30:230].T),
                             jg, view=view)


def _f32_values(rng, n: int) -> np.ndarray:
    """float32 values with ties, exact +0 / -0 and a wide range."""
    pool = np.concatenate([
        rng.standard_normal(n).astype(np.float32) * 40.0,
        rng.integers(-3, 4, n).astype(np.float32),
        np.array([0.0, -0.0, 1e-38, -1e-38, 3.0e38, -3.0e38], np.float32)])
    values = rng.choice(pool, n).astype(np.float32)
    values[(values == 0) & (rng.random(n) < 0.5)] = -0.0
    return values


def test_plane_identities_on_float32_pairs():
    """(cur - lo) + (cur - hi) == H(B) - H(B - phi) and cur - next ==
    -P(next), up to the sign of a zero result; added to any total that is
    not -0 (every sum the stencil forms starts at +0), the two give the
    same bits."""
    rng = np.random.default_rng(0)
    n = 200_000
    with np.errstate(over="ignore", invalid="ignore"):
        cur, lo, hi, nxt = (_f32_values(rng, n) for _ in range(4))
        total = _f32_values(rng, n)
        total[total == 0] = np.float32(0.0)                     # never -0
        pair = (cur - lo) + (cur - hi)
        planes = (cur - hi) - (lo - cur)                        # H(B) - H(B-phi)
        keep = np.isfinite(pair) & np.isfinite(planes)
        assert keep.mean() > 0.99
        np.testing.assert_array_equal(pair[keep], planes[keep])
        zero = keep & (pair == 0)
        assert zero.sum() > 100 and (np.signbit(pair[zero])
                                     != np.signbit(planes[zero])).any()
        np.testing.assert_array_equal(
            (total + pair)[keep].view(np.uint32),
            (total + planes)[keep].view(np.uint32))
        p_next = nxt - cur                                      # P(fr + tau)
        ok = np.isfinite(p_next) & np.isfinite(total - p_next)
        np.testing.assert_array_equal(
            (total + (cur - nxt))[ok].view(np.uint32),
            (total - p_next)[ok].view(np.uint32))
        assert ((cur - nxt) == 0).sum() > 100
        # the sign of a zero term never shows in a sum that is not -0
        plus = np.float32(0.0)
        assert not np.signbit(plus + np.float32(-0.0))
        assert not np.signbit(plus - np.float32(0.0))
