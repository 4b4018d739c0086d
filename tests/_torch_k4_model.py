"""A numpy model of K4's OSD search (``csrc/osd_eliminate.cu``
``osd_decode_kernel``), step by step in the kernel's arithmetic: the
stable rank of each bit by counting |LLR| keys (unsigned bit patterns, NaN
last), the
elimination (the port's plain version, ``ops/osd_cuda.py``), the order-0
codeword as an XOR of rows, the lanes' partial sums and the warp's
butterfly sum (dist0, the weight total, the pivots' weight), each row's
correction summed over its set bits in column order from zero, the
order-2 rows as those with the most pivot columns above none of theirs,
the pairs' and triples' overlaps as lane sums (lane l: columns l + 32 w)
added by the butterfly, the all-zero guard as a popcount, the CRC as the
candidate's own syndrome, the winner by the first smallest admissible
distance, and the codeword back in natural order.  Every float is float32 and every sum runs in the kernel's order,
so the model's decisions are the kernel's bit for bit.  No JAX: the card's
tests import it too.

:func:`decode` gives (plain, ok) for (R, 174) LLRs and the candidates'
distances and flags for :func:`near_ties`, which finds the rows whose
decision a few ulp of a float32 sum could turn (a nonzero gap within
1e-5; exact ties are decided by the first index everywhere).
"""

from itertools import combinations
from typing import NamedTuple

import numpy as np
import torch

from ft8_demodulator_tpu_torch.ops import osd as tosd
from ft8_demodulator_tpu_torch.ops import osd_cuda as tosc

N, K, W = 174, 91, 6
SYND_SHIFT = N - 32 * (W - 1)
F32 = np.float32
CHUNK = 512
# relative margin within which a float32 sum's order may turn a decision
NEAR = 1e-5


class Search(NamedTuple):
    plain: np.ndarray        # (R, 174) int32, natural bit order
    ok: np.ndarray           # (R,) bool
    dist: np.ndarray         # (R, C) float32, the candidates in index order
    valid: np.ndarray        # (R, C) bool: CRC holds and not all-zero
    gate: np.ndarray         # (R,) float32


def ranks(llr: np.ndarray) -> np.ndarray:
    """rank(i) = #{j: m_j > m_i} + #{j < i: m_j == m_i}, m the |LLR| bit
    patterns plus one as unsigned integers, 0 for NaN (last, as
    torch.sort puts it)."""
    llr = np.ascontiguousarray(llr, F32)
    mag = np.where(np.isnan(llr), np.uint32(0),
                   (llr.view(np.uint32) & np.uint32(0x7fffffff))
                   + np.uint32(1))
    lower = np.tri(N, k=-1, dtype=bool)          # [i, j]: j < i
    out = np.empty(mag.shape, np.int64)
    for s in range(0, mag.shape[0], CHUNK):
        m = mag[s: s + CHUNK]
        mi, mj = m[:, :, None], m[:, None, :]
        out[s: s + CHUNK] = ((mj > mi) | ((mj == mi) & lower)).sum(-1)
    return out


def _bits(words: np.ndarray) -> np.ndarray:
    """(..., 6) uint32 -> (..., 174) bool code bits."""
    b = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return b.reshape(*words.shape[:-1], W * 32)[..., :N].astype(bool)


def _weight(words: np.ndarray) -> np.ndarray:
    return _bits(words).sum(-1)


def _syndrome(words: np.ndarray) -> np.ndarray:
    return (words[..., W - 1] >> np.uint32(SYND_SHIFT)) & np.uint32(0x3fff)


def _masked_sum(bits: np.ndarray, u: np.ndarray) -> np.ndarray:
    """bits (R, ..., 174), u (R, 174) -> (R, ...) float32: u over the set
    bits in column order, from zero."""
    acc = np.zeros(bits.shape[:-1], F32)
    ue = u.reshape(u.shape[:1] + (1,) * (bits.ndim - 2) + u.shape[1:])
    for c in range(N):
        acc = acc + np.where(bits[..., c], ue[..., c], F32(0))
    return acc


def _warp_sum(parts: np.ndarray) -> np.ndarray:
    """(..., 32) lane partials -> (...) the butterfly's sum."""
    lanes = np.arange(32)
    for s in (16, 8, 4, 2, 1):
        parts = parts + parts[..., lanes ^ s]
    return parts[..., 0]


def _lane_sum(bits: np.ndarray, u: np.ndarray) -> np.ndarray:
    """bits (R, ..., 174), u (R, 174) -> (R, ...) float32: lane l adds u at
    its set columns l + 32 w in order of w from zero, then the butterfly."""
    lead = bits.shape[:-1]
    b = np.zeros(lead + (W * 32,), bool)
    b[..., :N] = bits
    b = b.reshape(lead + (W, 32))
    uu = np.zeros((u.shape[0], W * 32), F32)
    uu[:, :N] = u
    uu = uu.reshape(u.shape[:1] + (1,) * (bits.ndim - 2) + (W, 32))
    parts = np.zeros(lead + (32,), F32)
    for w in range(W):
        parts = parts + np.where(b[..., w, :], uu[..., w, :], F32(0))
    return _warp_sum(parts)


def _search(llr, order, red, pcol, lam, order2, order3) -> Search:
    r = llr.shape[0]
    rows = np.arange(r)[:, None]
    ls = np.take_along_axis(llr, order, 1)                  # sorted LLRs
    sel = np.take_along_axis(ls, pcol.astype(np.int64), 1) > 0
    base = np.bitwise_xor.reduce(np.where(sel[..., None], red, 0), axis=1)
    wt = np.abs(ls)
    d0 = _bits(base) ^ (ls > 0)
    u = np.where(d0, -wt, wt).astype(F32)
    pad = np.zeros((r, W * 32), F32)
    wt192, d192 = pad.copy(), np.zeros((r, W * 32), bool)
    wt192[:, :N], d192[:, :N] = wt, d0
    total = np.zeros((r, 32), F32)
    dist0 = np.zeros((r, 32), F32)
    for w in range(W):
        seg = slice(32 * w, 32 * w + 32)
        total = total + wt192[:, seg]
        dist0 = dist0 + np.where(d192[:, seg], wt192[:, seg], F32(0))
    piv = np.zeros((r, 32), F32)
    pw = np.abs(np.take_along_axis(ls, pcol.astype(np.int64), 1))
    for g in range(3):
        n = min(32, K - 32 * g)
        piv[:, :n] = piv[:, :n] + pw[:, 32 * g: 32 * g + n]
    dist0, total, piv = _warp_sum(dist0), _warp_sum(total), _warp_sum(piv)
    gate = F32(lam) * (total - piv)

    dists = [dist0[:, None]]
    flips = [np.zeros((r, 1, W), np.uint32)]
    red_bits = _bits(red)
    delta = _masked_sum(red_bits, u)                          # (R, 91)
    dists.append(dist0[:, None] + delta)
    flips.append(red)
    if order2:
        above = (pcol[:, None, :] > pcol[:, :, None]).sum(-1)  # (R, 91)
        sub = np.argsort(above, axis=1, kind="stable")[:, :order2]
        assert (np.take_along_axis(above, sub, 1) == np.arange(order2)).all()
        a_sub = red[rows, sub]                                # (R, P, 6)
        d_sub = np.take_along_axis(delta, sub, 1)
        b_sub = red_bits[rows, sub]
        ov = _lane_sum(b_sub[:, :, None, :] & b_sub[:, None, :, :], u)
        d2 = (dist0[:, None, None] + d_sub[:, :, None]) + d_sub[:, None, :]
        d2 = d2 - F32(2) * ov
        upper = np.triu(np.ones((order2, order2), bool), 1)
        d2 = np.where(upper, d2, F32(np.inf))     # i >= j: never admissible
        dists.append(d2.reshape(r, -1))
        flips.append((a_sub[:, :, None] ^ a_sub[:, None, :]).reshape(
            r, -1, W))
        if order3 >= 3:
            t = np.array(list(combinations(range(order3), 3)))
            ti, tj, tk = t.T
            tu = _lane_sum(b_sub[:, ti] & b_sub[:, tj] & b_sub[:, tk], u)
            ovs = (ov[:, ti, tj] + ov[:, ti, tk]) + ov[:, tj, tk]
            d3 = ((dist0[:, None] + d_sub[:, ti]) + d_sub[:, tj]) \
                + d_sub[:, tk]
            d3 = (d3 - F32(2) * ovs) + F32(4) * tu
            dists.append(d3)
            flips.append(a_sub[:, ti] ^ a_sub[:, tj] ^ a_sub[:, tk])
    dist = np.concatenate(dists, 1).astype(F32)
    cw = base[:, None, :] ^ np.concatenate(flips, 1)          # (R, C, 6)
    valid = (_syndrome(cw) == 0) & (_weight(cw) > 0) & np.isfinite(dist)
    adm = valid & (dist <= gate[:, None])
    masked = np.where(adm, dist, F32(np.inf))
    best = masked.argmin(1)
    ok = adm[np.arange(r), best]
    best = np.where(ok, best, 0)
    win = _bits(cw[np.arange(r), best])                       # sorted
    plain = np.zeros((r, N), np.int32)
    np.put_along_axis(plain, order, win.astype(np.int32), 1)
    return Search(plain, ok, dist, valid, gate)


def decode(llr, lam=tosd.DEFAULT_LAMBDA, order2=tosd.DEFAULT_ORDER2,
           order3=tosd.DEFAULT_ORDER3) -> Search:
    """(R, 174) LLRs -> the kernel's Search (order3 < 3: no triples)."""
    llr = np.ascontiguousarray(llr, F32).reshape(-1, N)
    rank = ranks(llr)
    order = np.argsort(rank, axis=1)
    tables = tosd.osd_tables(torch.device("cpu"))
    parts = []
    for s in range(0, llr.shape[0], CHUNK):
        o = order[s: s + CHUNK]
        red, pcol = tosc.reduce_basis_from_order_plain(torch.as_tensor(o),
                                                       tables)
        parts.append(_search(llr[s: s + CHUNK], o,
                             red.numpy().view(np.uint32), pcol.numpy(),
                             lam, order2, order3 if order3 >= 3 else 0))
    if not parts:
        e = np.zeros((0,), F32)
        return Search(np.zeros((0, N), np.int32), np.zeros(0, bool),
                      e[:, None], np.zeros((0, 1), bool), e)
    return Search(*(np.concatenate(f) for f in zip(*parts)))


def near_ties(s: Search) -> np.ndarray:
    """(R,) bool: rows that a few ulp of a float32 sum's order could turn.
    A row is named when a valid candidate's distance lies within NEAR
    relative of the gate, or an admissible one within NEAR of the smallest
    admissible distance, by a gap that is not zero.  Distances equal bit
    for bit (exact sums, as on a grid of halves) name nothing: there the
    first index decides, on the card as in the CPU route."""
    tiny = np.finfo(F32).tiny
    gate = s.gate[:, None].astype(np.float64)
    d = s.dist.astype(np.float64)
    with np.errstate(invalid="ignore"):
        off = np.abs(d - gate)
        at_gate = s.valid & (off > 0) & (off <= NEAR * np.maximum(
            np.abs(gate), tiny))
        adm = s.valid & (d <= gate)
        masked = np.where(adm, d, np.inf)
        best = masked.min(1, initial=np.inf)[:, None]
        gap = masked - best
        tied = adm & (gap > 0) & (gap <= NEAR * np.maximum(best, tiny))
    return at_gate.any(1) | tied.any(1)
