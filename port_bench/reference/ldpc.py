"""The plain reference decoder's back half: LDPC(174,91) belief propagation,
the CRC-14 check, ordered-statistics decoding (OSD) and the payload bytes.

A frozen copy of the program's plain versions, with its tables built here
again from the protocol's parity checks and generator:

* BP: sum-product over the check and variable slots, with ft8_lib's
  rational tanh / atanh; a row halts on a zero syndrome (keeping that
  codeword) or on the all-zero hard decision (without improving its
  error count), and the loop ends when every row has halted;
* OSD on the valid rows BP left: sort the bits by |LLR| (stable), reduce the
  permuted generator basis over GF(2) (first free row with the bit becomes
  the pivot), then search order 0, every single pivot-row flip and the
  pairs of the 16 least reliable pivot rows; a flip is accepted on CRC-14,
  a non-zero codeword and a soft distance within 0.33 of the non-pivot
  reliability mass, the closest accepted one wins.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as C

__all__ = ["Tables", "tables", "bp_decode", "crc_of", "osd_decode",
           "finish_decode"]

_M, _N, _K = C.LDPC_M, C.LDPC_N, C.LDPC_K
_CD, _VD = C.CHECK_MAX_DEG, C.VAR_MAX_DEG
_W = (_N + 31) // 32
_SYND_SHIFT = _N - 32 * (_W - 1)
_SYND_MASK = (1 << C.CRC_BITS) - 1
OSD_LAMBDA = 0.33
OSD_ORDER2 = 16
OSD_CHUNK = 1024


class Tables(NamedTuple):
    var_of_mi: torch.Tensor
    loo_a: torch.Tensor
    loo_b: torch.Tensor
    mi_of_nj: torch.Tensor
    mi_mask: torch.Tensor
    parity_t: torch.Tensor     # (174, 83) float32
    crc_t: torch.Tensor        # (77, 14) float32
    basis_t: torch.Tensor      # (174, 91) uint8
    synd_word: torch.Tensor    # (91,) int32


def tables(device) -> Tables:
    """Every table the back half reads, on ``device``."""
    nmi = _M * _CD
    var_of_mi = np.zeros(nmi, np.int64)
    nj_of_mi = np.zeros(nmi, np.int64)
    mi_of_nj = np.zeros(_N * _VD, np.int64)
    mask = np.zeros(nmi, bool)
    for m in range(_M):
        for i in range(C.CHECK_DEG[m]):
            mi = i * _M + m
            n = C.CHECK_ADJ[m, i]
            j = C.CHECK_SLOT_IN_VAR[m, i]
            var_of_mi[mi] = n
            nj_of_mi[mi] = j * _N + n
            mi_of_nj[j * _N + n] = mi
            mask[mi] = True
    slots = np.arange(_VD)[None, :] * _N + var_of_mi[:, None]
    pairs = slots[slots != nj_of_mi[:, None]].reshape(nmi, _VD - 1)

    basis = np.zeros((_K, _N), np.uint8)
    basis[:, :_K] = np.eye(_K, dtype=np.uint8)
    basis[:, _K:] = C.LDPC_GENERATOR.T
    synd = np.zeros((C.CRC_BITS, _N), np.int64)
    synd[:, : C.PAYLOAD_BITS] = C.CRC_MATRIX_77
    synd[:, C.PAYLOAD_BITS: _K] = np.eye(C.CRC_BITS, dtype=np.int64)
    row_synd = (synd @ basis.astype(np.int64).T).T % 2          # (91, 14)
    word = (row_synd << (_SYND_SHIFT + np.arange(C.CRC_BITS))).sum(-1)

    t = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=device)
    return Tables(
        var_of_mi=t(var_of_mi, torch.int64), loo_a=t(pairs[:, 0], torch.int64),
        loo_b=t(pairs[:, 1], torch.int64), mi_of_nj=t(mi_of_nj, torch.int64),
        mi_mask=t(mask, torch.bool),
        parity_t=t(C.PARITY_CHECK.T.astype(np.float32), torch.float32),
        crc_t=t(C.CRC_MATRIX_77.T.astype(np.float32), torch.float32),
        basis_t=t(np.ascontiguousarray(basis.T), torch.uint8),
        synd_word=t(word.astype(np.int32), torch.int32))


# ---------------------------------------------------------------------------
# BP
# ---------------------------------------------------------------------------

def _tanh(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, -4.97, 4.97)
    x2 = x * x
    return x * (945.0 + x2 * (105.0 + x2)) / (945.0 + x2 * (420.0 + x2 * 15.0))


def _atanh(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    return x * (945.0 + x2 * (-735.0 + x2 * 64.0)) \
        / (945.0 + x2 * (-1050.0 + x2 * 225.0))


def _errors(plain: torch.Tensor, tb: Tables) -> torch.Tensor:
    return torch.remainder(plain.to(torch.float32) @ tb.parity_t, 2.0) \
        .sum(-1).to(torch.int32)


def bp_decode(llrs: torch.Tensor, max_iterations: int, tb: Tables):
    """(R, 174) LLRs -> (plain (R, 174) int32, best syndrome weight (R,));
    the messages in the LLRs' dtype."""
    rows, dev = llrs.shape[0], llrs.device
    tov = torch.zeros((rows, _N * _VD), dtype=llrs.dtype, device=dev)
    plain_out = torch.zeros((rows, _N), dtype=torch.int32, device=dev)
    min_err = torch.full((rows,), _M, dtype=torch.int32, device=dev)
    halted = torch.zeros(rows, dtype=torch.bool, device=dev)
    llr_routed = llrs[:, tb.var_of_mi]
    for _ in range(max_iterations):
        if bool(halted.all()):
            break
        total = llrs + tov[:, :_N] + tov[:, _N: 2 * _N] + tov[:, 2 * _N:]
        plain = (total > 0).to(torch.int32)
        zero_cw = plain.sum(-1) == 0
        errors = _errors(plain, tb)
        live = ~halted
        min_err = torch.where(live & ~zero_cw, torch.minimum(min_err, errors),
                              min_err)
        plain_out = torch.where(live[:, None], plain, plain_out)
        halted = halted | (live & (zero_cw | (errors == 0)))

        tnm = llr_routed + (tov[:, tb.loo_a] + tov[:, tb.loo_b])
        toc = torch.where(tb.mi_mask, _tanh(-tnm / 2.0), 1.0)
        blocks = [toc[:, i * _M: (i + 1) * _M] for i in range(_CD)]
        pre, suf = [None] * _CD, [None] * _CD
        acc = torch.ones_like(blocks[0])
        for i in range(_CD):
            pre[i] = acc
            acc = acc * blocks[i]
        acc = torch.ones_like(blocks[0])
        for i in range(_CD - 1, -1, -1):
            suf[i] = acc
            acc = acc * blocks[i]
        excl = torch.cat([pre[i] * suf[i] for i in range(_CD)], dim=-1)
        tov = torch.where(halted[:, None], tov,
                          -2.0 * _atanh(excl[:, tb.mi_of_nj]))
    return plain_out, min_err


def crc_of(plain: torch.Tensor, tb: Tables):
    """(R, 174) bits -> (CRC-14 of the payload bits, the CRC they carry)."""
    weights = 2 ** torch.arange(C.CRC_BITS - 1, -1, -1, device=plain.device,
                                dtype=torch.int32)
    bits = torch.remainder(plain[:, : C.PAYLOAD_BITS].to(torch.float32)
                           @ tb.crc_t, 2.0).to(torch.int32)
    return ((bits * weights).sum(-1, dtype=torch.int32),
            (plain[:, C.PAYLOAD_BITS: _K] * weights).sum(-1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# OSD
# ---------------------------------------------------------------------------

def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., <= 192) {0,1} -> (..., 6) int32 words, bit j at word j // 32."""
    b = torch.nn.functional.pad(bits.to(torch.int32), (0, _W * 32 - bits.shape[-1]))
    weights = torch.ones(32, dtype=torch.int32, device=bits.device) \
        << torch.arange(32, dtype=torch.int32, device=bits.device)
    return (b.reshape(*bits.shape[:-1], _W, 32) * weights).sum(-1,
                                                              dtype=torch.int32)


def _unpack(words: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., :, None] >> shifts) & 1).reshape(
        *words.shape[:-1], _W * 32).to(torch.float32)


def _reduce(order: torch.Tensor, tb: Tables):
    """(B, 174) reliability order -> (reduced packed bases (B, 91, 6) with
    the row syndromes in bits 174.., pivot columns (B, 91))."""
    a = _pack(tb.basis_t[order].transpose(1, 2))
    a[..., _W - 1] |= tb.synd_word
    b = a.shape[0]
    rows = torch.arange(_K, device=a.device)
    take = torch.arange(b, device=a.device)
    used = torch.zeros((b, _K), dtype=torch.bool, device=a.device)
    pcol = torch.zeros((b, _K), dtype=torch.int32, device=a.device)
    for j in range(_N):
        if b == 0 or bool(used.all()):
            break
        col = ((a[:, :, j >> 5] >> (j & 31)) & 1).bool()
        avail = col & ~used
        i = avail.to(torch.int8).argmax(dim=1)
        found = avail.any(dim=1, keepdim=True)
        pivot = (rows == i[:, None]) & found
        elim = col & found & ~pivot
        a ^= torch.where(elim[..., None], a[take, i][:, None, :], 0)
        used |= pivot
        pcol = torch.where(pivot, j, pcol)
    return a, pcol


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _search(llr_sorted, order, a, pcol, lam: float, order2: int):
    """Order 0, 1 and the pairs of the ``order2`` least reliable pivot rows
    -> (plain (B, 174) int32 in natural order, accepted (B,))."""
    b = llr_sorted.shape[0]
    w = llr_sorted.abs()
    r = (llr_sorted > 0).to(torch.float32)
    pivot_llr = torch.gather(llr_sorted, 1, pcol.to(torch.int64))
    sel = (pivot_llr > 0).to(torch.float32)
    a_full = _unpack(a)
    base_full = torch.remainder(torch.bmm(sel[:, None, :], a_full)[:, 0], 2.0)
    base = base_full[:, :_N]
    a_bits = a_full[:, :, :_N]
    d0 = (base - r).abs()
    dist0 = (w * d0).sum(-1)
    u = w * (1.0 - 2.0 * d0)
    delta = (a_bits * u[:, None, :]).sum(-1)
    dist = torch.cat([dist0[:, None], dist0[:, None] + delta], dim=1)
    s_rows = (a[..., _W - 1] >> _SYND_SHIFT) & _SYND_MASK
    s_base = (_pack(base_full)[:, _W - 1] >> _SYND_SHIFT) & _SYND_MASK
    crc_ok = torch.cat([s_base[:, None] == 0,
                        (s_rows ^ s_base[:, None]) == 0], dim=1)
    v2 = 1.0 - 2.0 * base
    dones = (a_bits * v2[:, None, :]).sum(-1)
    ones0 = base.sum(-1)
    crc_ok &= torch.cat([ones0[:, None], ones0[:, None] + dones], 1) > 0.5

    p = order2
    sub = torch.sort(pcol, dim=1, descending=True, stable=True).indices[:, :p]
    a_sub = _rows(a_bits, sub)
    d_sub = torch.gather(delta, 1, sub)
    dn_sub = torch.gather(dones, 1, sub)
    s_sub = torch.gather(s_rows, 1, sub)
    ov = torch.bmm(a_sub * u[:, None, :], a_sub.transpose(1, 2))
    ov2 = torch.bmm(a_sub * v2[:, None, :], a_sub.transpose(1, 2))
    dist2 = dist0[:, None, None] + d_sub[:, :, None] + d_sub[:, None, :] \
        - 2.0 * ov
    ones2 = ones0[:, None, None] + dn_sub[:, :, None] + dn_sub[:, None, :] \
        - 2.0 * ov2
    crc2 = (s_sub[:, :, None] ^ s_sub[:, None, :]) == s_base[:, None, None]
    upper = torch.ones((p, p), dtype=torch.bool, device=a.device).triu(1)
    dist = torch.cat([dist, dist2.reshape(b, p * p)], dim=1)
    crc_ok = torch.cat([crc_ok, (crc2 & (ones2 > 0.5) & upper)
                        .reshape(b, p * p)], dim=1)

    mass = w.sum(-1) - pivot_llr.abs().sum(-1)
    masked = torch.where(crc_ok & (dist <= lam * mass[:, None]), dist,
                         torch.inf)
    best = masked.argmin(dim=1)
    ok = torch.isfinite(torch.gather(masked, 1, best[:, None])[:, 0])
    flip = _rows(a_bits, (best - 1).clamp(0, _K - 1)[:, None])[:, 0]
    flip = torch.where(((best >= 1) & (best <= _K))[:, None], flip, 0.0)
    q2 = (best - (_K + 1)).clamp(0, p * p - 1)
    pair = _rows(a_sub, torch.stack([q2 // p, q2 % p], 1))
    flip = torch.where((best > _K)[:, None], torch.remainder(pair.sum(1), 2.0),
                       flip)
    win = torch.remainder(base + flip, 2.0)
    return torch.zeros_like(win).scatter_(1, order, win).to(torch.int32), ok


def osd_decode(llrs: torch.Tensor, need: torch.Tensor, tb: Tables):
    """OSD of the rows of (R, 174) ``llrs`` where ``need`` -> (plain (R,
    174) int32, accepted (R,)); other rows (zeros, False)."""
    plain = torch.zeros(llrs.shape, dtype=torch.int32, device=llrs.device)
    ok = torch.zeros(llrs.shape[:1], dtype=torch.bool, device=llrs.device)
    idx = need.nonzero()[:, 0]
    if idx.numel():
        flat = llrs[idx]
        order = torch.sort(-flat.abs(), dim=-1, stable=True).indices
        llr_sorted = torch.gather(flat, 1, order)
        red, pcol = _reduce(order, tb)
        parts = [_search(llr_sorted[i: i + OSD_CHUNK], order[i: i + OSD_CHUNK],
                         red[i: i + OSD_CHUNK], pcol[i: i + OSD_CHUNK],
                         OSD_LAMBDA, OSD_ORDER2)
                 for i in range(0, flat.shape[0], OSD_CHUNK)]
        plain[idx], ok[idx] = (torch.cat(x) for x in zip(*parts))
    return plain, ok


class Decoded(NamedTuple):
    """(R,) rows: success, payload (R, 10) uint8, computed CRC, best
    syndrome weight."""

    success: torch.Tensor
    payload: torch.Tensor
    crc: torch.Tensor
    ldpc_errors: torch.Tensor


def finish_decode(llrs: torch.Tensor, valid: torch.Tensor,
                  max_iterations: int, use_osd: bool, tb: Tables) -> Decoded:
    """(R, 174) LLRs, (R,) candidate validity -> BP, CRC, (OSD on the valid
    rows BP left), payload bytes."""
    plain, errors = bp_decode(llrs, max_iterations, tb)
    crc, carried = crc_of(plain, tb)
    if use_osd:
        bp_ok = (errors == 0) & (crc == carried)
        osd_plain, take = osd_decode(llrs, valid & ~bp_ok, tb)
        plain = torch.where(take[:, None], osd_plain, plain)
        errors = torch.where(take, 0, errors)
        crc, carried = crc_of(plain, tb)
    bits80 = torch.cat([plain[:, : C.PAYLOAD_BITS],
                        plain.new_zeros((plain.shape[0], 3))], dim=-1)
    weights = 2 ** torch.arange(7, -1, -1, device=plain.device,
                                dtype=torch.int32)
    payload = (bits80.reshape(-1, C.PAYLOAD_BYTES, 8) * weights).sum(-1) \
        .to(torch.uint8)
    return Decoded(valid & (errors == 0) & (crc == carried), payload, crc,
                   errors)
