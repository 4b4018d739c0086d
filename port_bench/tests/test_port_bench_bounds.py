"""The roofline yardstick against counts made by hand for one launch of
K1, K3, K5 and K6 at the cells' shapes (12 kHz, 15-s slots)."""

from __future__ import annotations

import math

from port_bench import bounds
from port_bench.reference import front

N = 180_000                      # samples in a 15-s slot at 12 kHz


def test_k1_batch16_osr2():
    p = front.geometry(12000, 2, 2)          # hop 960, 1,920 bins
    # 186 frames, 187 hop blocks, 1,924 extended columns (halo of 2 a side)
    ops = 4 * 187 * 960 * 1924 * 16          # cos and sin multiply-adds
    nbytes = (4 * 16 * N                     # float32 audio in
              + 2 * 2 * 960 * 1924           # bf16 cos and sin
              + 4 * 2 * 2 * 1924             # float32 combine phases
              + 4 * 16 * 186 * 1920)         # float32 dB grid out
    b = bounds.waterfall(p, 16, N, box=False)
    assert (b.ops, b.nbytes, b.by) == (ops, nbytes, "operations")
    assert math.isclose(b.seconds, ops / 989e12, rel_tol=1e-12)


def test_k3_batch8_osr4():
    p = front.geometry(12000, 4, 4)          # hop 480, 3,840 bins
    # 372 frames, 375 blocks, 3,848 columns; the boxcar grid has 378 rows
    ops = 4 * 375 * 480 * 3848 * 8
    nbytes = (4 * 8 * N + 2 * 2 * 480 * 3848 + 4 * 2 * 4 * 3848
              + 4 * 8 * 372 * 3840 + 4 * 8 * 378 * 3840)
    b = bounds.waterfall(p, 8, N, box=True)
    assert (b.ops, b.nbytes, b.by) == (ops, nbytes, "bytes")
    assert math.isclose(b.seconds, nbytes / 3.35e12, rel_tol=1e-12)


def _terms(time_osr: int, t_start: int, num_times: int, num_blocks: int):
    """Valid stencil terms over all start times, counted symbol by symbol:
    each in-slot Costas cell once, plus its previous and next symbol where
    those are in the slot too."""
    n = 0
    for t in range(t_start, t_start + num_times):
        base = t // time_osr
        for m in range(3):
            for k in range(7):
                b = base + 36 * m + k
                if 0 <= b < num_blocks:
                    n += 1 + (k > 0 and b > 0) + (k < 6 and b + 1 < num_blocks)
    return n


def test_k5_chunk16_osr2():
    g = front.search_grid(1920, 186, 2, 2)
    assert (g.t_start, g.num_times, g.num_freqs, g.num_blocks) == \
        (-20, 88, 1906, 93)
    cells, grid = 16 * 88 * 1906, 16 * 186 * 1920
    b = bounds.sync(g, 16, 186, 1920)
    assert b.ops == 16 * 1906 * _terms(2, -20, 88, 93) + 3 * grid
    assert (b.nbytes, b.by) == (4 * (grid + cells), "bytes")
    assert math.isclose(b.seconds, b.nbytes / 3.35e12, rel_tol=1e-12)


def test_k6_capture_osr4():
    g = front.search_grid(3840, 372, 4, 4)
    assert (g.t_start, g.num_times, g.num_freqs, g.num_blocks) == \
        (-40, 176, 3812, 93)
    cells, grid = 176 * 3812, 372 * 3840
    b = bounds.sync(g, 1, 372, 3840)
    assert b.ops == 3812 * _terms(4, -40, 176, 93) + 3 * grid
    assert (b.nbytes, b.by) == (4 * (grid + cells), "bytes")
    assert math.isclose(b.seconds, b.nbytes / 3.35e12, rel_tol=1e-12)
