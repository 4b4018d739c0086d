"""A numpy model of K8 (``csrc/llr_gather.cu``), row by row and lane by
lane: the cells each symbol reads, the Gray order, the masks, the max-of-4
contrasts, and the scale's sums in the warp's order (each lane's own
symbols, then the butterfly).  No JAX: the card's tests import it too.

:func:`bit_llrs` gives the LLRs before scaling, :func:`scales` the factor
K8 computes from them; the plain version's scale sums in another order.
"""

import numpy as np

from ft8_demodulator_tpu_torch.protocol import constants as C

F32 = np.float32
# the Gray-ordered positions j with bit b (MSB first) set / clear
_SET = [[j for j in range(8) if (j >> (2 - b)) & 1] for b in range(3)]
_CLEAR = [[j for j in range(8) if not (j >> (2 - b)) & 1] for b in range(3)]


def bit_llrs(grid, abs_time, abs_freq, tau, phi, num_blocks, matched,
             gray=C.GRAY_MAP):
    """``grid`` (T, F) float32 in logical order (any numpy strides),
    candidates (K,) -> (K, 174) float32: K8's LLRs before scaling.  A cell
    whose flat index frame * F + bin lies outside the grid reads NaN."""
    frames, bins = grid.shape
    flat = np.ascontiguousarray(grid, dtype=F32).reshape(-1)
    out = np.zeros((len(abs_time), 58, 3), F32)
    for i, (t, f) in enumerate(zip(np.asarray(abs_time, np.int64),
                                   np.asarray(abs_freq, np.int64))):
        off = f + np.asarray(gray, np.int64) * phi
        for s, pos in enumerate(C.DATA_SYMBOL_POSITIONS.astype(np.int64)):
            if matched:
                r = t + pos * tau + tau - 1
                counts = 0 <= r < frames
            else:
                counts = 0 <= t // tau + pos < num_blocks
                r = min(max(t + pos * tau, 0), frames - 1)
            if not counts:
                continue
            cell = r * bins + off
            inside = (cell >= 0) & (cell < flat.size)
            v = np.where(inside, flat[np.clip(cell, 0, flat.size - 1)],
                         F32(np.nan)).astype(F32)
            if matched:
                v = (F32(10.0) * np.log10(F32(1e-12) + v)).astype(F32)
            out[i, s] = [v[_SET[b]].max() - v[_CLEAR[b]].max()
                         for b in range(3)]
    return out.reshape(len(abs_time), 174)


def _warp_sum(lanes):
    """The butterfly over 32 lanes: every lane ends with the same total."""
    lanes = np.asarray(lanes, F32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(F32)
    return lanes[0]


def _lane_sums(values):
    """(58, 3) -> (32,) each lane's running float32 sum of its symbols' 3
    values (lane l holds symbols l and l + 32)."""
    sums = np.zeros(32, F32)
    for lane in range(32):
        acc = F32(0.0)
        for s in (lane, lane + 32):
            if s < 58:
                for b in range(3):
                    acc = F32(acc + values[s, b])
        sums[lane] = acc
    return sums


def scales(llrs):
    """(K, 174) LLRs before scaling -> (K,) float32: K8's factor, mean and
    variance summed in the warp's order."""
    out = np.zeros(len(llrs), F32)
    for i, row in enumerate(np.asarray(llrs, F32).reshape(-1, 58, 3)):
        mean = F32(_warp_sum(_lane_sums(row)) / F32(174.0))
        d = (row - mean).astype(F32)
        var = F32(_warp_sum(_lane_sums((d * d).astype(F32))) / F32(174.0))
        if var < F32(1e-30):
            var = F32(1e-30)
        out[i] = np.sqrt(F32(F32(1.0) / var) * F32(24.0))
    return out


def ulps(a, b):
    """|a - b| in units in the last place of float32 (finite, same sign)."""
    ia = np.asarray(a, F32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, F32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)
