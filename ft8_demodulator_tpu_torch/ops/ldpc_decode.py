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
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..protocol import constants as C
from ..utils.profiling import count, host_wait

__all__ = ["fast_tanh", "fast_atanh", "ldpc_check", "bp_decode",
           "bp_decode_batch", "BPTables", "bp_tables", "make_bp_tables"]

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


def make_bp_tables(var_of_mi, nj_of_mi, mi_of_nj, mi_mask, parity_check,
                   device) -> BPTables:
    """BPTables on ``device`` from the numpy routing vectors and the
    (83, 174) parity-check matrix."""
    var_of_mi, nj_of_mi = np.asarray(var_of_mi), np.asarray(nj_of_mi)
    loo_a, loo_b = _leave_one_out_pairs(var_of_mi, nj_of_mi)
    idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                    device=device)
    return BPTables(
        var_of_mi=idx(var_of_mi), loo_a=idx(loo_a), loo_b=idx(loo_b),
        mi_of_nj=idx(mi_of_nj),
        mi_mask=torch.as_tensor(np.asarray(mi_mask) > 0, device=device),
        parity_t=torch.as_tensor(np.asarray(parity_check, np.float32).T,
                                 device=device).contiguous())


@functools.lru_cache(maxsize=8)
def bp_tables(device: torch.device) -> BPTables:
    """The routing tables built by this module, cached per device."""
    return make_bp_tables(*_build_routing(), C.PARITY_CHECK, device)


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


def ldpc_check(plain: torch.Tensor, tables: BPTables | None = None
               ) -> torch.Tensor:
    """(..., 174) hard bits -> number of failed parity checks (int32).

    The float32 product is exact: 0/1 operands, integer sums <= 7.
    """
    if tables is None:
        tables = bp_tables(plain.device)
    syndrome = torch.remainder(plain.to(torch.float32) @ tables.parity_t,
                               2.0)
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


def bp_decode_batch(llrs: torch.Tensor, max_iterations: int = 20,
                    tables: BPTables | None = None):
    """(..., 174) LLRs -> (plain (..., 174) int32, min_errors (...,) int32).

    Fixed-shape equivalent of the reference's bp_decode: a halted mask
    freezes each row's state once the reference would have left its loop,
    and the loop ends when every row has halted.  ``tables``: routing
    tables on the device of ``llrs``; None takes :func:`bp_tables`.
    Counters (``utils/profiling.py``): ``bp.calls``, ``bp.rows``,
    ``bp.iterations`` (iterations run) and ``bp.all_halted`` (early exits).
    """
    if tables is None:
        tables = bp_tables(llrs.device)
    batch_shape = llrs.shape[:-1]
    dev = llrs.device
    tov = torch.zeros((*batch_shape, _NNJ), dtype=torch.float32, device=dev)
    plain_out = torch.zeros((*batch_shape, _N), dtype=torch.int32,
                            device=dev)
    min_err = torch.full(batch_shape, _M, dtype=torch.int32, device=dev)
    halted = torch.zeros(batch_shape, dtype=torch.bool, device=dev)

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
        errors = ldpc_check(plain, tables)

        live = ~halted
        # reference order: the zero-codeword break happens before the error
        # check, so min_errors must not absorb the zero codeword's syndrome
        min_err = torch.where(live & ~zero_cw, torch.minimum(min_err, errors),
                              min_err)
        plain_out = torch.where(live[..., None], plain, plain_out)
        halted = halted | (live & (zero_cw | (errors == 0)))

        tov_next = _bp_iteration(llr_routed, tov, tables)
        tov = torch.where(halted[..., None], tov, tov_next)
    count("bp.iterations", iterations)
    return plain_out, min_err


def bp_decode(llr: torch.Tensor, max_iterations: int = 20,
              tables: BPTables | None = None):
    """Single-codeword convenience wrapper: (174,) -> ((174,), scalar)."""
    plain, err = bp_decode_batch(llr[None, :], max_iterations, tables)
    return plain[0], err[0]
