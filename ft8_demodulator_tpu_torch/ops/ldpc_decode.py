"""LDPC(174,91) sum-product belief propagation, batched.

Port of ``ft8_demodulator_tpu/ops/ldpc_decode.py``.  Messages live in flat
slot-major arrays: (..., 522) variable->check, slot j's block of all 174
variables contiguous, and (..., 581) check->variable, slot i's block of all
83 checks contiguous.  The JAX package routes between the two layouts with
0/±1 matmuls (a TPU workaround); here the routes are index gathers built
from the same ``_build_routing`` vectors:

* ``llr_routed = llrs[var_of_mi]``;
* the leave-one-out variable sum is the sum of the variable's two other
  slot messages, ``tov[loo_a] + tov[loo_b]`` (one add: the same float32
  value the ±1 matmul produces);
* ``tmn = excl[mi_of_nj]``.

The leave-one-out product over each check's <=7 slots is an exclusive
prefix/suffix product over 7 contiguous (..., 83) blocks, in the
reference's order.  tanh/atanh are the reference's rational (Padé)
approximations.  Early exit follows the reference with a halted mask:

* a hard decision on the (forbidden) all-zero codeword freezes the row
  without improving min_errors,
* zero parity errors freeze the row with that codeword,
* otherwise min_errors tracks the best syndrome weight seen,

and the loop stops once every row has halted.

That loop is the plain version (:func:`bp_decode_batch_plain`, with each
row's iteration count; :func:`bp_crc_batch_plain` adds the CRC-14).  On a
CUDA tensor :func:`bp_decode_batch` and :func:`bp_crc_batch` launch the
kernel K7 instead (``ops/ldpc_cuda.py``, ``csrc/ldpc_bp.cu``): every
iteration of every row and the CRC in one launch, each row leaving its loop
where the plain version freezes it, bit for bit the plain version's
results.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..protocol import constants as C
from ..protocol.tables import device_table
from ..utils.profiling import count, count_on_card, host_wait, recording
from .ldpc_cuda import bp_crc_kernel, pack_table

__all__ = ["fast_tanh", "fast_atanh", "ldpc_check", "crc_of_plain",
           "bp_decode", "bp_decode_batch", "bp_decode_batch_plain",
           "bp_crc_batch", "bp_crc_batch_plain", "BPDecode", "BPTables",
           "bp_tables"]

_M, _N = C.LDPC_M, C.LDPC_N
_CD, _VD = C.CHECK_MAX_DEG, C.VAR_MAX_DEG
_NMI = _M * _CD     # 581 flat (slot, check) pairs, slot-major: mi = i*83 + m
_NNJ = _N * _VD     # 522 flat (slot, var) pairs, slot-major: nj = j*174 + n


def _build_routing():
    """Constant routing index vectors between the two slot-major layouts."""
    var_of_mi = np.zeros(_NMI, np.int32)   # variable read by check-slot mi
    nj_of_mi = np.zeros(_NMI, np.int32)    # (var, slot) excluded by mi
    mi_of_nj = np.full(_NNJ, 0, np.int32)  # check-slot feeding var-slot nj
    mask = np.zeros(_NMI, np.float32)
    for m in range(_M):
        for i in range(C.CHECK_DEG[m]):
            mi = i * _M + m
            n = C.CHECK_ADJ[m, i]
            j = C.CHECK_SLOT_IN_VAR[m, i]
            var_of_mi[mi] = n
            nj_of_mi[mi] = j * _N + n
            mi_of_nj[j * _N + n] = mi
            mask[mi] = 1.0
    return var_of_mi, nj_of_mi, mi_of_nj, mask


def _leave_one_out_pairs(var_of_mi: np.ndarray, nj_of_mi: np.ndarray):
    """(581,) x2: the two slot messages of var_of_mi[mi] other than
    nj_of_mi[mi], ascending."""
    slots = np.arange(_VD)[None, :] * _N + var_of_mi[:, None]   # (581, 3)
    keep = slots != nj_of_mi[:, None]
    if not (keep.sum(-1) == _VD - 1).all():
        raise ValueError("nj_of_mi must name one slot of var_of_mi")
    pairs = slots[keep].reshape(_NMI, _VD - 1)
    return pairs[:, 0], pairs[:, 1]


class BPTables(NamedTuple):
    """Routing tables of one device (int64 indices, float32 tables)."""

    var_of_mi: torch.Tensor    # (581,)
    loo_a: torch.Tensor        # (581,)
    loo_b: torch.Tensor        # (581,)
    mi_of_nj: torch.Tensor     # (522,)
    mi_mask: torch.Tensor      # (581,) bool
    parity_t: torch.Tensor     # (174, 83) float32 0/1
    crc_t: torch.Tensor        # (77, 14) float32 0/1, the CRC generator
    k7_table: torch.Tensor     # (ldpc_cuda.TABLE_WORDS,) int32, K7's


@functools.lru_cache(maxsize=8)
def bp_tables(device: torch.device) -> BPTables:
    """The routing tables, the (83, 174) parity-check matrix and the
    (14, 77) CRC generator on ``device``, built once per device (K7's table
    holds the last two packed; the plain version reads ``crc_t``)."""
    var_of_mi, nj_of_mi, mi_of_nj, mi_mask = _build_routing()
    loo_a, loo_b = _leave_one_out_pairs(var_of_mi, nj_of_mi)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    f32_t = lambda name: device_table(name, device, torch.float32).T \
        .contiguous()
    return BPTables(
        var_of_mi=idx(var_of_mi), loo_a=idx(loo_a), loo_b=idx(loo_b),
        mi_of_nj=idx(mi_of_nj),
        mi_mask=torch.as_tensor(mi_mask > 0, device=device),
        parity_t=f32_t("PARITY_CHECK"), crc_t=f32_t("CRC_MATRIX_77"),
        k7_table=torch.as_tensor(pack_table(var_of_mi, nj_of_mi, mi_mask,
                                            C.PARITY_CHECK, C.CRC_MATRIX_77),
                                 device=device))


def fast_tanh(x: torch.Tensor) -> torch.Tensor:
    """Rational tanh approximation, input clipped to +-4.97 (ft8_lib form)."""
    x = torch.clamp(x, -4.97, 4.97)
    x2 = x * x
    a = x * (945.0 + x2 * (105.0 + x2))
    b = 945.0 + x2 * (420.0 + x2 * 15.0)
    return a / b


def fast_atanh(x: torch.Tensor) -> torch.Tensor:
    """Rational atanh approximation (ft8_lib form)."""
    x2 = x * x
    a = x * (945.0 + x2 * (-735.0 + x2 * 64.0))
    b = 945.0 + x2 * (-1050.0 + x2 * 225.0)
    return a / b


def ldpc_check(plain: torch.Tensor) -> torch.Tensor:
    """(..., 174) hard bits -> number of failed parity checks (int32).

    The float32 product is exact: 0/1 operands, integer sums <= 7.
    """
    syndrome = torch.remainder(
        plain.to(torch.float32) @ bp_tables(plain.device).parity_t, 2.0)
    return syndrome.sum(-1).to(torch.int32)


def _bp_iteration(llr_routed: torch.Tensor, tov: torch.Tensor,
                  tables: BPTables) -> torch.Tensor:
    """One sum-product iteration; tov is slot-major (..., 522)."""
    tnm = llr_routed + (tov[..., tables.loo_a] + tov[..., tables.loo_b])
    toc = torch.where(tables.mi_mask, fast_tanh(-tnm / 2.0), 1.0)

    # leave-one-out products over the 7 slot blocks (exclusive prefix/suffix)
    blocks = [toc[..., i * _M: (i + 1) * _M] for i in range(_CD)]
    pre = [None] * _CD
    suf = [None] * _CD
    acc = torch.ones_like(blocks[0])
    for i in range(_CD):
        pre[i] = acc
        acc = acc * blocks[i]
    acc = torch.ones_like(blocks[0])
    for i in range(_CD - 1, -1, -1):
        suf[i] = acc
        acc = acc * blocks[i]
    excl = torch.cat([pre[i] * suf[i] for i in range(_CD)], dim=-1)

    tmn = excl[..., tables.mi_of_nj]                           # (..., 522)
    return -2.0 * fast_atanh(tmn)


def _tov_sum(llrs: torch.Tensor, tov: torch.Tensor) -> torch.Tensor:
    """llr + per-variable sum of the 3 slot blocks (slot-major layout)."""
    return (llrs + tov[..., 0 * _N: 1 * _N] + tov[..., 1 * _N: 2 * _N]
            + tov[..., 2 * _N: 3 * _N])


def crc_of_plain(plain: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 174) hard bits -> (computed CRC-14, embedded CRC-14) per row.

    The float32 product is exact: 0/1 operands, integer sums <= 77.
    """
    crc_t = bp_tables(plain.device).crc_t
    weights = 2 ** torch.arange(C.CRC_BITS - 1, -1, -1, device=plain.device,
                                dtype=torch.int32)
    bits77 = plain[..., : C.PAYLOAD_BITS].to(torch.float32)
    crc_bits = torch.remainder(bits77 @ crc_t, 2.0).to(torch.int32)
    crc_calc = (crc_bits * weights).sum(-1, dtype=torch.int32)
    crc_extracted = (plain[..., C.PAYLOAD_BITS: C.LDPC_K] * weights) \
        .sum(-1, dtype=torch.int32)
    return crc_calc, crc_extracted


class BPDecode(NamedTuple):
    """BP + CRC of candidate rows (batch shape ``...``), all int32."""

    plain: torch.Tensor          # (..., 174) hard bits of the last iteration
    ldpc_errors: torch.Tensor    # (...,) fewest parity errors seen
    crc_calc: torch.Tensor       # (...,) CRC-14 of bits 0..76
    crc_extracted: torch.Tensor  # (...,) CRC-14 in bits 77..90
    iterations: torch.Tensor     # (...,) iterations the row ran


def bp_decode_batch_plain(llrs: torch.Tensor, max_iterations: int = 20):
    """(..., 174) LLRs -> (plain (..., 174) int32, min_errors (...,) int32,
    iterations (...,) int32), in plain PyTorch on any device.

    Fixed-shape equivalent of the reference's bp_decode: a halted mask
    freezes each row's state once the reference would have left its loop,
    and the loop ends when every row has halted (a wait for the card each
    iteration); a row's iterations are those it was live in.
    Counters (``utils/profiling.py``): ``bp.calls``, ``bp.rows``,
    ``bp.iterations`` (iterations run), ``bp.all_halted`` (early exits)
    and, while a profiler records, ``bp.row_iterations`` (their sum over
    rows, on the rows' device).
    """
    tables = bp_tables(llrs.device)
    batch_shape = llrs.shape[:-1]
    dev = llrs.device
    tov = torch.zeros((*batch_shape, _NNJ), dtype=torch.float32, device=dev)
    plain_out = torch.zeros((*batch_shape, _N), dtype=torch.int32,
                            device=dev)
    min_err = torch.full(batch_shape, _M, dtype=torch.int32, device=dev)
    halted = torch.zeros(batch_shape, dtype=torch.bool, device=dev)
    row_iterations = torch.zeros(batch_shape, dtype=torch.int32, device=dev)

    llr_routed = llrs[..., tables.var_of_mi]   # loop-invariant
    count("bp.calls")
    count("bp.rows", halted.numel())
    iterations = 0
    for _ in range(max_iterations):
        with host_wait("ft8.decode.wait"):
            done = bool(halted.all())
        if done:
            count("bp.all_halted")
            break
        iterations += 1
        plain = (_tov_sum(llrs, tov) > 0).to(torch.int32)
        zero_cw = plain.sum(-1) == 0
        errors = ldpc_check(plain)

        live = ~halted
        row_iterations += live
        # reference order: the zero-codeword break happens before the error
        # check, so min_errors must not absorb the zero codeword's syndrome
        min_err = torch.where(live & ~zero_cw, torch.minimum(min_err, errors),
                              min_err)
        plain_out = torch.where(live[..., None], plain, plain_out)
        halted = halted | (live & (zero_cw | (errors == 0)))

        tov_next = _bp_iteration(llr_routed, tov, tables)
        tov = torch.where(halted[..., None], tov, tov_next)
    count("bp.iterations", iterations)
    count_on_card("bp.row_iterations", row_iterations)
    return plain_out, min_err, row_iterations


def bp_crc_batch_plain(llrs: torch.Tensor, max_iterations: int = 20
                       ) -> BPDecode:
    """Plain PyTorch version of K7: :func:`bp_decode_batch_plain`, then
    :func:`crc_of_plain`."""
    plain, errors, iterations = bp_decode_batch_plain(llrs, max_iterations)
    crc_calc, crc_extracted = crc_of_plain(plain)
    return BPDecode(plain, errors, crc_calc, crc_extracted, iterations)


def bp_crc_batch(llrs: torch.Tensor, max_iterations: int = 20) -> BPDecode:
    """(..., 174) float32 LLRs -> BPDecode, as :func:`bp_crc_batch_plain`.

    A CPU tensor goes through the plain version; a CUDA tensor through K7,
    all rows in one launch (none for 0 rows; a launch failure raises), with
    the CRC generator packed in :func:`bp_tables`' ``k7_table``.
    Counters on the card: ``bp.calls``, ``bp.rows`` and ``k7.launches``;
    while a profiler records, on the card, ``bp.iterations`` (the slowest
    row's), ``bp.all_halted`` (1 if it exited before ``max_iterations``)
    and ``bp.row_iterations`` (their sum).
    """
    if llrs.device.type == "cpu":
        return bp_crc_batch_plain(llrs, max_iterations)
    batch_shape = llrs.shape[:-1]
    flat = llrs.reshape(-1, _N).contiguous()
    rows = flat.shape[0]
    count("bp.calls")
    count("bp.rows", rows)
    plain, stats = bp_crc_kernel(flat, max_iterations,
                                 bp_tables(llrs.device).k7_table)
    if rows and recording():
        slowest = stats[3].max()
        count_on_card("bp.iterations", slowest)
        count_on_card("bp.all_halted", slowest < max_iterations)
        count_on_card("bp.row_iterations", stats[3])
    return BPDecode(plain.reshape(*batch_shape, _N),
                    *(s.reshape(batch_shape) for s in stats))


def bp_decode_batch(llrs: torch.Tensor, max_iterations: int = 20):
    """(..., 174) LLRs -> (plain (..., 174) int32, min_errors (...,) int32)
    of :func:`bp_crc_batch`."""
    return bp_crc_batch(llrs, max_iterations)[:2]


def bp_decode(llr: torch.Tensor, max_iterations: int = 20):
    """Single-codeword convenience wrapper: (174,) -> ((174,), scalar)."""
    plain, err = bp_decode_batch(llr[None, :], max_iterations)
    return plain[0], err[0]
