"""The yardstick of a kernel's roofline: the least time one H100 could take
for one launch, from the launch's shapes alone.

The larger of the operations over their peak rate and the bytes over the
memory rate; each input byte read once and each output byte written once.
Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W: 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s float32 outside them (an FMA counted as two, so
separately rounded adds run at half that), 3.35 TB/s of HBM3.  The same
arithmetic as the program's chip_smoke.py ``_bound``, ``_waterfall_bound``
and ``_sync_adds``, kept here so that a later change to the program cannot
move the yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

from .reference import front

__all__ = ["PEAK_BF16", "PEAK_F32", "PEAK_F32_ADDS", "PEAK_BYTES", "Bound",
           "bound", "waterfall", "sync"]

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_F32_ADDS = PEAK_F32 / 2
PEAK_BYTES = 3.35e12


class Bound(NamedTuple):
    seconds: float
    by: str            # "operations" or "bytes"
    ops: float
    nbytes: float


def bound(ops: float, nbytes: float, peak_ops: float) -> Bound:
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return Bound(max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
                 else "bytes", ops, nbytes)


def waterfall(p: front.Geometry, batch: int, n: int, box: bool) -> Bound:
    """One launch of the fused waterfall kernel (its pre-pass included) on
    ``batch`` slots of ``n`` samples: the DFT's multiply-adds (cos and sin,
    the halo not counted) on the bf16 tensor cores; the float32 audio, the
    bf16 cos/sin and float32 combine constants in, the float32 dB grid (and
    with ``box`` the boxcar grid) out."""
    nf = p.num_frames(n)
    nb = nf + p.time_osr - 1
    kx = p.num_freq_bins + 2 * p.freq_osr
    rows = nf + 2 * (p.time_osr - 1)
    nbytes = (4 * batch * n + 2 * 2 * p.hop * kx + 4 * 2 * p.time_osr * kx
              + 4 * batch * nf * p.num_freq_bins
              + (4 * batch * rows * p.num_freq_bins if box else 0))
    return bound(4 * nb * p.hop * kx * batch, nbytes, PEAK_BF16)


def sync(g: front.SearchGrid, batch: int, num_frames: int,
         num_freq_bins: int) -> Bound:
    """One launch of the sync stencil kernel over ``batch`` float32 dB grids
    of (num_frames, num_freq_bins), in the kernel's plane design: one add
    per valid term of every score cell (the Costas cell, previous-symbol
    and next-symbol masks) and 3 subtractions per grid value (its H, D and
    P planes), as single float32 instructions; the grids in, the scores
    out."""
    terms = sum(int(m.sum()) for m in front._cell_masks(g))
    cells = batch * g.num_times * g.num_freqs
    grid = batch * num_frames * num_freq_bins
    return bound(cells // g.num_times * terms + 3 * grid, 4 * (grid + cells),
                 PEAK_F32_ADDS)
