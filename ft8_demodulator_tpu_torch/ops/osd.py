"""Ordered-statistics decoding (OSD) of the LDPC(174,91) code, batched.

Port of ``ft8_demodulator_tpu/ops/osd.py``.  When belief propagation does
not yield a CRC-valid codeword, OSD re-derives one from the 91 most
reliable linearly independent bit positions: sort the bits by |LLR|,
permute the code's (91, 174) basis into that order and row-reduce it over
GF(2), and take the codeword that agrees with the hard decision on the
pivots (order 0).
The search also tries every single pivot-row flip (order 1), XOR-pairs of
the ``order2`` least reliable pivot rows and triples of the ``order3``
least reliable ones, and keeps the accepted candidate closest to the
received soft values.

Acceptance is CRC-14 plus a soft-distance gate: every OSD output is a
codeword by construction, so there is no syndrome check; the
reliability-weighted disagreement with the hard decision must stay within
``lam`` times the non-pivot reliability mass.  The 14 CRC syndrome bits of
each basis row ride along through the elimination in packed bits 174..187,
so a flip's CRC check is one XOR of 14-bit integers.

On a CUDA tensor the whole OSD of a call is one launch of the K4 kernel
(``ops/osd_cuda.py osd_kernel``): the sort, the elimination, the search
and the winner, a warp a row.  On the CPU it is the plain route below,
the kernel's plain version: a stable ``torch.sort``, the elimination's
plain version (``ops/osd_cuda.py reduce_basis_from_order``) and
:func:`_osd_tail` in passes of ``chunk`` rows.  The JAX package builds the
permuted basis with a matmul outside its elimination kernel and selects
rows with one-hot multiply-reduces (TPU workarounds); here the basis comes
from the sort order, and the rows are gathers.
The gate's float32 sums run in another order than XLA's (and the kernel's
in another than the plain route's), so a candidate whose distance sits
within a few ulp of ``lam`` times its mass, or of another candidate's, can
fall on the other side; the tests state the margins they see.
"""

from __future__ import annotations

import functools
from itertools import combinations
from typing import NamedTuple

import numpy as np
import torch

from ..protocol import constants as C
from ..utils.profiling import count, count_on_card, host_wait, span
from .osd_cuda import (_pack, check_kernel_orders, osd_kernel,
                       reduce_basis_from_order)

__all__ = ["OSDTables", "osd_tables", "osd_decode_batch",
           "osd_decode_masked", "DEFAULT_LAMBDA", "DEFAULT_ORDER2",
           "DEFAULT_ORDER3"]

_N, _K = C.LDPC_N, C.LDPC_K
_W = (_N + 31) // 32          # 6 words per 174-bit row
# CRC syndrome bit b rides in packed bit 174 + b: bit 14 + b of word 5
_SYND_SHIFT = _N - 32 * (_W - 1)
_SYND_MASK = (1 << C.CRC_BITS) - 1

DEFAULT_LAMBDA = 0.33
DEFAULT_ORDER2 = 16
DEFAULT_ORDER3 = 0
# rows per pass of the CPU route's search: bounds the (rows, 91, 192)
# unpacked basis (the elimination takes all of a call's rows at once)
DEFAULT_CHUNK = 1024


def _basis() -> np.ndarray:
    """(91, 174) GF(2) basis of the code: rows [e_i | column i of parity]."""
    b = np.zeros((_K, _N), np.uint8)
    b[:, :_K] = np.eye(_K, dtype=np.uint8)
    b[:, _K:] = C.LDPC_GENERATOR.T          # (91, 83)
    return b


def _syndrome_matrix() -> np.ndarray:
    """(14, 174) S with S @ codeword == 0 (mod 2) iff the embedded CRC-14
    matches the CRC of the 77-bit payload (bits 91..173 unconstrained)."""
    s = np.zeros((C.CRC_BITS, _N), np.float32)
    s[:, : C.PAYLOAD_BITS] = C.CRC_MATRIX_77
    s[:, C.PAYLOAD_BITS: _K] = np.eye(C.CRC_BITS, dtype=np.float32)
    return s


# fixed CRC syndromes of the (natural-order) basis rows, (91, 14)
_ROW_SYNDROMES_NP = ((_syndrome_matrix().astype(np.int64)
                      @ _basis().astype(np.int64).T).T % 2).astype(np.uint8)


class OSDTables(NamedTuple):
    """The basis constants of one device."""

    basis_t: torch.Tensor      # (174, 91) uint8: column n of the basis
    synd_word: torch.Tensor    # (91,) int32: row syndromes at word-5 bits
    # (3 * 174 + 91,) int32, the kernel's table: words 3n..3n+2 hold
    # column n's row bits (row k at bit k % 32 of word 3n + k // 32), then
    # synd_word
    basis_cols: torch.Tensor


@functools.lru_cache(maxsize=8)
def osd_tables(device: torch.device) -> OSDTables:
    """OSDTables on ``device`` from the (91, 174) basis bits and the
    (91, 14) row syndromes, built once per device."""
    bits = _basis()
    syn = _ROW_SYNDROMES_NP.astype(np.int64)
    word = (syn << (_SYND_SHIFT + np.arange(C.CRC_BITS))).sum(-1)
    groups = -(-_K // 32)
    rows = np.zeros((groups * 32, _N), np.int64)
    rows[:_K] = bits
    cols = (rows.reshape(groups, 32, _N)
            << np.arange(32)[None, :, None]).sum(1)        # (3, 174)
    table = np.concatenate([cols.T.reshape(-1), word]).astype(np.uint32)
    return OSDTables(
        basis_t=torch.as_tensor(np.ascontiguousarray(bits.T), device=device),
        synd_word=torch.as_tensor(word.astype(np.int32), device=device),
        basis_cols=torch.as_tensor(table.view(np.int32), device=device))


@functools.lru_cache(maxsize=8)
def _triples(q: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """:func:`_triple_indices` of ``q`` on ``device``, built once."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in _triple_indices(q))


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """(..., 6) int32 -> (..., 192) {0,1} float32 (all packed columns:
    174 code bits then 14 ride-along syndrome bits then 4 zeros)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], _W * 32).to(torch.float32)


def _triple_indices(q: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    idx = np.array(list(combinations(range(q), 3)), np.int64).reshape(-1, 3)
    return idx[:, 0], idx[:, 1], idx[:, 2]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, R, n), idx (B, P) -> (B, P, n): rows idx[b] of x[b]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _osd_tail(llr_sorted: torch.Tensor, order: torch.Tensor, a: torch.Tensor,
              pcol: torch.Tensor, lam: float, order2: int = 0,
              order3: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Order-0/1 (+ partial order-2/3) search on reduced bases.

    llr_sorted (B, 174) LLRs in reliability order, order (B, 174) the
    natural bit index at each sorted position, a (B, 91, 6) reduced packed
    syndrome-augmented bases in sorted column layout, pcol (B, 91) their
    pivot columns.  Returns (plain (B, 174) int32 in natural bit order,
    accepted (B,) bool).

    Flip distances are the order-0 distance plus a linear correction
    A_f . (w * (1 - 2 d0)); a pair's is the two singles' minus twice their
    overlap, a triple's adds the third-order term.  A flip's CRC syndrome
    is the XOR of the order-0 syndrome with its rows' syndromes.
    """
    b = llr_sorted.shape[0]
    dev = llr_sorted.device
    w_nat = llr_sorted.abs()
    r_nat = (llr_sorted > 0).to(torch.float32)
    pivot_llr = torch.gather(llr_sorted, 1, pcol.to(torch.int64))  # (B, 91)

    # order-0 codeword: XOR of the rows whose pivot bit is set in r; the
    # 0/1 sums (<= 91) are exact in float32
    sel = (pivot_llr > 0).to(torch.float32)
    a_full = _unpack(a)                                     # (B, 91, 192)
    base_full = torch.remainder(
        torch.bmm(sel[:, None, :], a_full)[:, 0], 2.0)      # (B, 192)
    base = base_full[:, :_N]
    a_bits = a_full[:, :, :_N]                              # (B, 91, 174)

    d0 = (base - r_nat).abs()
    dist0 = (w_nat * d0).sum(-1)                            # (B,)
    u = w_nat * (1.0 - 2.0 * d0)
    delta = (a_bits * u[:, None, :]).sum(-1)                # (B, 91)
    dist = torch.cat([dist0[:, None], dist0[:, None] + delta], dim=1)

    # CRC: syndromes as 14-bit integers
    s_rows = (a[..., _W - 1] >> _SYND_SHIFT) & _SYND_MASK   # (B, 91)
    s_base = (_pack(base_full)[:, _W - 1] >> _SYND_SHIFT) & _SYND_MASK
    crc_ok = torch.cat([s_base[:, None] == 0,
                        (s_rows ^ s_base[:, None]) == 0], dim=1)

    # reject the all-zero codeword (BP's zero-codeword guard); exact
    v2 = 1.0 - 2.0 * base
    dones = (a_bits * v2[:, None, :]).sum(-1)               # (B, 91)
    ones0 = base.sum(-1)
    crc_ok &= torch.cat([ones0[:, None], ones0[:, None] + dones], 1) > 0.5

    if order2 > 0:
        p = order2
        # the P least reliable pivot rows, largest pivot column first
        sub = torch.sort(pcol, dim=1, descending=True,
                         stable=True).indices[:, :p]
        a_sub = _rows(a_bits, sub)                          # (B, P, 174)
        d_sub = torch.gather(delta, 1, sub)
        dn_sub = torch.gather(dones, 1, sub)
        s_sub = torch.gather(s_rows, 1, sub)
        ov = torch.bmm(a_sub * u[:, None, :], a_sub.transpose(1, 2))
        ov2 = torch.bmm(a_sub * v2[:, None, :], a_sub.transpose(1, 2))
        dist2 = (dist0[:, None, None] + d_sub[:, :, None]
                 + d_sub[:, None, :] - 2.0 * ov)
        ones2 = (ones0[:, None, None] + dn_sub[:, :, None]
                 + dn_sub[:, None, :] - 2.0 * ov2)
        crc2 = (s_sub[:, :, None] ^ s_sub[:, None, :]) == s_base[:, None, None]
        upper = torch.ones((p, p), dtype=torch.bool, device=dev).triu(1)
        ok2 = crc2 & (ones2 > 0.5) & upper
        dist = torch.cat([dist, dist2.reshape(b, p * p)], dim=1)
        crc_ok = torch.cat([crc_ok, ok2.reshape(b, p * p)], dim=1)

    if order3 > 0:
        ti, tj, tk = _triples(order3, dev)
        a3 = a_sub[:, :order3]
        ov3, ov23 = ov[:, :order3, :order3], ov2[:, :order3, :order3]
        d3, dn3 = d_sub[:, :order3], dn_sub[:, :order3]
        s3 = s_sub[:, :order3]
        t_u = ((a3 * u[:, None, :])[:, ti] * a3[:, tj] * a3[:, tk]).sum(-1)
        t_v = ((a3 * v2[:, None, :])[:, ti] * a3[:, tj] * a3[:, tk]).sum(-1)
        dist3 = (dist0[:, None] + d3[:, ti] + d3[:, tj] + d3[:, tk]
                 - 2.0 * (ov3[:, ti, tj] + ov3[:, ti, tk] + ov3[:, tj, tk])
                 + 4.0 * t_u)
        ones3 = (ones0[:, None] + dn3[:, ti] + dn3[:, tj] + dn3[:, tk]
                 - 2.0 * (ov23[:, ti, tj] + ov23[:, ti, tk]
                          + ov23[:, tj, tk])
                 + 4.0 * t_v)
        crc3 = (s3[:, ti] ^ s3[:, tj] ^ s3[:, tk]) == s_base[:, None]
        dist = torch.cat([dist, dist3], dim=1)
        crc_ok = torch.cat([crc_ok, crc3 & (ones3 > 0.5)], dim=1)

    nonpivot_mass = w_nat.sum(-1) - pivot_llr.abs().sum(-1)
    gate = dist <= lam * nonpivot_mass[:, None]
    masked = torch.where(crc_ok & gate, dist, torch.inf)
    best = masked.argmin(dim=1)                  # the first smallest
    ok = torch.isfinite(torch.gather(masked, 1, best[:, None])[:, 0])

    # the winner's flip pattern
    in1 = (best >= 1) & (best <= _K)
    flip = _rows(a_bits, (best - 1).clamp(0, _K - 1)[:, None])[:, 0]
    flip = torch.where(in1[:, None], flip, 0.0)
    n2 = order2 * order2
    if order2 > 0:
        in2 = (best > _K) & (best <= _K + n2)
        q2 = (best - (_K + 1)).clamp(0, n2 - 1)
        pair = _rows(a_sub, torch.stack([q2 // order2, q2 % order2], 1))
        flip = torch.where(in2[:, None], torch.remainder(pair.sum(1), 2.0),
                           flip)
    if order3 > 0:
        tri = (best - (_K + 1 + n2)).clamp(0, len(ti) - 1)
        trip = _rows(a3, torch.stack([ti[tri], tj[tri], tk[tri]], 1))
        flip = torch.where((best > _K + n2)[:, None],
                           torch.remainder(trip.sum(1), 2.0), flip)
    win_sorted = torch.remainder(base + flip, 2.0)
    # back to natural bit order: position r holds natural bit order[r]
    win_nat = torch.zeros_like(win_sorted).scatter_(1, order, win_sorted)
    return win_nat.to(torch.int32), ok


def _check_orders(order2: int, order3: int) -> int:
    """Validate the search orders; returns the effective order3."""
    if order3 > order2:
        raise ValueError(f"order3 ({order3}) must be <= order2 ({order2}):"
                         " the triple rows come from the order-2 set")
    return order3 if order3 >= 3 else 0   # C(order3, 3) == 0: no triples


def _none(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(zeros like the plain codewords, False for every row) of (R, 174)
    LLRs: what a row OSD does not search returns."""
    return (torch.zeros(flat.shape, dtype=torch.int32, device=flat.device),
            torch.zeros(flat.shape[:1], dtype=torch.bool, device=flat.device))


def _osd_rows(flat: torch.Tensor, lam: float, order2: int, order3: int,
              chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, 174) LLRs on the CPU -> (plain (R, 174) int32, ok (R,) bool):
    the plain route.

    Reliability sort -> reduced bases (all R rows at once) -> the search,
    in passes of ``chunk`` rows (the body is row-independent).  The sort is
    stable: tied |LLR| (zero LLRs are common) keep their natural order, as
    ``lax.sort`` does.
    """
    if flat.shape[0] == 0:
        return _none(flat)
    order = torch.sort(-flat.abs(), dim=-1, stable=True).indices
    llr_sorted = torch.gather(flat, 1, order)
    red, pcol = reduce_basis_from_order(order, osd_tables(flat.device))
    parts = [_osd_tail(llr_sorted[i: i + chunk], order[i: i + chunk],
                       red[i: i + chunk], pcol[i: i + chunk], lam, order2,
                       order3)
             for i in range(0, flat.shape[0], chunk)]
    plain, ok = (torch.cat(p) for p in zip(*parts))
    return plain, ok


def osd_decode_batch(llrs: torch.Tensor, lam: float = DEFAULT_LAMBDA,
                     order2: int = DEFAULT_ORDER2,
                     order3: int = DEFAULT_ORDER3
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 174) LLRs -> (plain (..., 174) int32, accepted (...,) bool).

    order2: number of least reliable pivot rows whose XOR-pairs are also
    searched (0: the pure order-1 search).  order3 (<= order2): XOR-triples
    of the order3 least reliable pivot rows (values below 3 have no
    triples).
    """
    order3 = _check_orders(order2, order3)
    flat = llrs.reshape(-1, _N)
    if flat.device.type == "cuda":
        plain, ok = osd_kernel(flat, None, osd_tables(flat.device), lam,
                               order2, order3)
    else:
        plain, ok = _osd_rows(flat, lam, order2, order3, DEFAULT_CHUNK)
    return plain.reshape(llrs.shape), ok.reshape(llrs.shape[:-1])


@span("ft8.osd")
def osd_decode_masked(llrs: torch.Tensor, need: torch.Tensor,
                      lam: float = DEFAULT_LAMBDA,
                      order2: int = DEFAULT_ORDER2,
                      order3: int = DEFAULT_ORDER3,
                      chunk: int = DEFAULT_CHUNK
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """OSD only the rows where ``need`` is True.

    (..., 174) LLRs + (...,) bool -> (plain (..., 174) int32, ok (...,)
    bool).  Needed rows get exactly :func:`osd_decode_batch`'s result;
    the others return (zeros, False).  On a card the host reads the needed
    count once (``ft8.osd.wait``) and, if any, launches the kernel once over
    all rows (an unneeded row costs a warp that writes zeros); on the CPU
    the needed rows are compacted by a boolean index, run through the plain
    route in passes of ``chunk`` rows, and scattered back.  Runs in a
    ``ft8.osd`` span; counts the rows searched (``osd.rows``) and, while a
    profiler records, the rows accepted (``osd.accepted``, on the card).
    """
    order3 = _check_orders(order2, order3)
    flat = llrs.reshape(-1, _N)
    needf = need.reshape(-1)
    if flat.device.type == "cuda":
        check_kernel_orders(order2, order3)
        with host_wait("ft8.osd.wait"):
            rows = int(needf.sum())
        plain, ok = osd_kernel(flat, needf, osd_tables(flat.device), lam,
                               order2, order3) if rows else _none(flat)
    else:
        with host_wait("ft8.osd.wait"):
            idx = needf.nonzero()[:, 0]
        rows = idx.numel()
        plain, ok = _none(flat)
        if rows:
            plain[idx], ok[idx] = _osd_rows(flat[idx], lam, order2, order3,
                                            chunk)
    count("osd.rows", rows)
    if rows:
        count_on_card("osd.accepted", ok)
    return plain.reshape(llrs.shape), ok.reshape(need.shape)
