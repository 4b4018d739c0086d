"""LDPC BP + CRC-14 of candidate rows, on the card: the kernel K7.

The CUDA kernel ``csrc/ldpc_bp.cu`` runs every sum-product iteration of a
row and then its CRC in one launch, one warp a row, each row leaving its
loop where :func:`ops.ldpc_decode.bp_decode_batch_plain` freezes it; its
header note has the design.  It replaces no TPU kernel: the JAX package
runs this loop as one jitted ``lax.while_loop``
(``ft8_demodulator_tpu/ops/ldpc_decode.py:187``).

What bounds it on the card: the separately rounded float32 operations of
the Pade evaluations, about 30 k a row and iteration (:func:`bp_bound`);
a row's state stays in shared memory for all its iterations.

Its table (:func:`pack_table`, ``TABLE_WORDS`` int32 words, built once a
device with the BP tables) holds the routing of each (slot, check) pair,
the parity checks' adjacency as bit masks and the CRC generator's rows;
:func:`bp_crc_kernel` launches the kernel on a CUDA tensor or raises, and
counts the launch in ``k7.launches`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..protocol import constants as C
from ..utils.profiling import count

__all__ = ["pack_table", "bp_crc_kernel", "bp_bound", "TABLE_WORDS"]

_M, _N = C.LDPC_M, C.LDPC_N
_CD, _VD = C.CHECK_MAX_DEG, C.VAR_MAX_DEG
_NMI = _M * _CD
_VW = (_N + 31) // 32                       # words of a row's bits
_CRC_W = (C.PAYLOAD_BITS + 31) // 32        # words of a generator row
ADJ_AT = _NMI
CRC_AT = ADJ_AT + _VW * _M
TABLE_WORDS = CRC_AT + C.CRC_BITS * _CRC_W
_REAL = 1 << 10                             # a routing word's real slot
_MAX_ROWS = 2 ** 31 - 1                     # the C entry takes an int


def _words(bits: np.ndarray) -> np.ndarray:
    """(..., b) {0,1} -> (..., ceil(b / 32)) uint32, bit i in word i // 32,
    bit i % 32."""
    pad = -bits.shape[-1] % 32
    b = np.pad(np.asarray(bits, np.uint64), [(0, 0)] * (bits.ndim - 1)
               + [(0, pad)])
    b = b.reshape(*bits.shape[:-1], -1, 32)
    return (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def pack_table(var_of_mi, nj_of_mi, mi_mask, parity_check, crc_matrix
               ) -> np.ndarray:
    """The kernel's table as (TABLE_WORDS,) int32 (the uint32 bits):

    * ``mi`` < 581: slot i of check m (mi = i * 83 + m) reads variable n in
      bits 0..7 at its slot j (``nj_of_mi`` = j * 174 + n) in bits 8..9;
      bit 10 marks a real slot (``mi_mask``);
    * then the (83, 174) ``parity_check`` as 6 words a check, word w of
      check m at ``ADJ_AT + w * 83 + m``;
    * then the (14, 77) ``crc_matrix``, 3 words a row from ``CRC_AT``; row
      k is the CRC bit of weight 2^(13 - k).
    """
    var_of_mi = np.asarray(var_of_mi, np.int64)
    nj_of_mi = np.asarray(nj_of_mi, np.int64)
    real = np.asarray(mi_mask) > 0
    if (var_of_mi[real] != nj_of_mi[real] % _N).any():
        raise ValueError("nj_of_mi must name a slot of var_of_mi")
    route = np.where(real, var_of_mi | (nj_of_mi // _N) << 8 | _REAL, 0)
    adj = _words(np.asarray(parity_check)).T            # (6, 83)
    crc = _words(np.asarray(crc_matrix))                # (14, 3)
    table = np.concatenate([route.astype(np.uint32), adj.reshape(-1),
                            crc.reshape(-1)])
    if table.shape != (TABLE_WORDS,):
        raise ValueError(f"table of {table.shape[0]} words, want "
                         f"{TABLE_WORDS}")
    return table.view(np.int32)


def bp_bound(iterations: torch.Tensor) -> float:
    """Seconds the card needs at least to decode rows that ran
    ``iterations`` (per row) iterations: every separately rounded float32
    operation the algorithm makes, a division or a clamp bound as one, at
    33.5 T/s.  Each iteration's variable walk: three adds and a compare a
    variable.  Each check walk (every iteration but a row's last): per real
    (slot, check) pair two adds, a scaling, the clamped Pade tanh (12
    operations) and atanh (11), the -2 scaling, and its prefix, suffix and
    exclusive products (3)."""
    it = iterations.to(torch.int64)
    variable_walks = int(it.sum())
    check_walks = int((it - 1).clamp(min=0).sum())
    real = int(C.CHECK_DEG.sum())                         # 522
    ops = variable_walks * 4 * _N + check_walks * real * (2 + 1 + 12 + 11
                                                          + 1 + 3)
    return ops / 33.5e12


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    lib = kernel_library().lib
    lib.ft8_ldpc_bp.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ft8_ldpc_bp.restype = ctypes.c_int
    lib.ft8_ldpc_table_words.argtypes = []
    lib.ft8_ldpc_table_words.restype = ctypes.c_int
    if lib.ft8_ldpc_table_words() != TABLE_WORDS:
        raise RuntimeError(f"the kernel's table has "
                           f"{lib.ft8_ldpc_table_words()} words, the "
                           f"wrapper's {TABLE_WORDS}")
    lib.ft8_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bp_crc_kernel(llrs: torch.Tensor, max_iterations: int,
                  table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, 174) float32 LLRs, contiguous on a card -> (plain (rows, 174)
    int32, stats (4, rows) int32: min_errors, computed CRC, embedded CRC,
    iterations), one launch (none for 0 rows).  ``table``: the
    (TABLE_WORDS,) int32 of :func:`pack_table` on the same card.  A bad
    argument or a refused launch raises."""
    if llrs.dim() != 2 or llrs.shape[1] != _N \
            or llrs.dtype != torch.float32 or not llrs.is_contiguous():
        raise ValueError(f"llrs must be contiguous (rows, {_N}) float32, got "
                         f"{tuple(llrs.shape)} {llrs.dtype}")
    if llrs.device.type != "cuda":
        raise ValueError(f"no kernel for device {llrs.device}")
    if tuple(table.shape) != (TABLE_WORDS,) or table.dtype != torch.int32 \
            or table.device != llrs.device or not table.is_contiguous():
        raise ValueError(f"table {tuple(table.shape)} {table.dtype} on "
                         f"{table.device}: want ({TABLE_WORDS},) int32 "
                         f"contiguous on {llrs.device}")
    rows = llrs.shape[0]
    if rows > _MAX_ROWS or not 0 <= max_iterations <= _MAX_ROWS:
        raise ValueError(f"{rows} rows, {max_iterations} iterations")
    plain = torch.empty((rows, _N), dtype=torch.int32, device=llrs.device)
    stats = torch.empty((4, rows), dtype=torch.int32, device=llrs.device)
    if rows == 0:
        return plain, stats
    lib = _library()
    with torch.cuda.device(llrs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ft8_ldpc_bp(llrs.data_ptr(), table.data_ptr(),
                              plain.data_ptr(), stats.data_ptr(), rows,
                              max_iterations, stream)
    if err != 0:
        raise RuntimeError("ldpc_bp launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())
    count("k7.launches")
    return plain, stats
