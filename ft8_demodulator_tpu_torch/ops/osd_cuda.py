"""Reduced OSD bases from the reliability order, on the card.

Counterpart of the TPU kernel in ``ft8_demodulator_tpu/ops/osd.py:212``
(``_reduce_basis_pallas_batch``, :189) and of the permute-pack that feeds
it (``_permute_pack``, :90).  The CUDA kernel ``csrc/osd_eliminate.cu``
builds each candidate's reliability-permuted basis from its sort order and
the natural basis in shared memory, then row-reduces it over GF(2), one
warp per candidate with the 91 rows in registers (three per lane); its
header note has the design.

What bounds it on the card: the chain of ~100 dependent pivot steps per
candidate (1.4 KB of order in, 2.5 KB out), so the kernel wants many
candidates in flight; ``ops/osd.py`` hands it all of an OSD call's rows in
one launch (7,260 in a DEEP batch).

A basis is (91, 6) 32-bit words, held here as int32 (the kernel reads the
same bits as uint32): bit j of row k is bit j % 32 of word j // 32; code
columns 0..173 come in the candidate's reliability order and bits
174..187 carry each row's CRC syndrome.  :func:`_permute_pack` builds it
from the order; :func:`reduce_basis_batch_plain` is the elimination's
arithmetic (the JAX package's ``_reduce_basis_packed``, batched over
candidates); :func:`reduce_basis_from_order_plain`, the two composed, is
the kernel's plain version, and the kernel equals it bit for bit.
:func:`reduce_basis_from_order` takes the plain version for a CPU tensor;
for a CUDA tensor it launches the kernel or raises, and counts the launch
in the counter ``k4.launches`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..protocol import constants as C
from ..utils.profiling import count

__all__ = ["reduce_basis_from_order", "reduce_basis_from_order_plain",
           "reduce_basis_batch_plain"]

_N, _K = C.LDPC_N, C.LDPC_K
_W = (_N + 31) // 32          # 6 words per 174-bit row (+ syndrome bits)
_GROUPS = (_K + 31) // 32     # 32-bit words of a column's row bits
TABLE_WORDS = _GROUPS * _N + _K
_MAX_ROWS = 2 ** 31 - 1       # the C entry takes the count as an int


def _word_weights(device) -> torch.Tensor:
    """2^i, i < 32, as int32 (2^31 wraps to -2^31: the same 32 bits)."""
    w = torch.ones(32, dtype=torch.int32, device=device)
    return w << torch.arange(32, dtype=torch.int32, device=device)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., <=192) {0,1} -> (..., 6) int32, bit j in word j//32, bit j%32.

    The words are sums of distinct powers of two, so no partial sum leaves
    the int32 range, whatever the order.
    """
    pad = _W * 32 - bits.shape[-1]
    b = torch.nn.functional.pad(bits.to(torch.int32), (0, pad))
    b = b.reshape(*bits.shape[:-1], _W, 32)
    return (b * _word_weights(bits.device)).sum(-1, dtype=torch.int32)


def _permute_pack(order: torch.Tensor, tables) -> torch.Tensor:
    """(B, 174) reliability order (natural column at each sorted position)
    -> (B, 91, 6) column-permuted packed basis with the row syndromes in
    bits 174..187.  ``tables``: the device's ``ops.osd.OSDTables``."""
    bits = tables.basis_t[order]                       # (B, 174, 91) uint8
    words = _pack(bits.transpose(1, 2))                # (B, 91, 6)
    words[..., _W - 1] |= tables.synd_word
    return words


def reduce_basis_batch_plain(a: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-reduce packed bases (B, 91, 6) int32 -> (reduced (B, 91, 6)
    int32, pivot column per row (B, 91) int32).

    Column by column, the first row with the bit that holds no pivot yet
    becomes the pivot; every other row with the bit is XORed with it.  The
    basis has rank 91, so once every candidate has 91 pivots the later
    columns change nothing and the loop stops (exact).  A row without a
    pivot keeps column 0.
    """
    a = a.clone()
    b = a.shape[0]
    rows = torch.arange(_K, device=a.device)
    take = torch.arange(b, device=a.device)
    used = torch.zeros((b, _K), dtype=torch.bool, device=a.device)
    pcol = torch.zeros((b, _K), dtype=torch.int32, device=a.device)
    for j in range(_N):
        if b == 0 or bool(used.all()):
            break
        col = ((a[:, :, j >> 5] >> (j & 31)) & 1).bool()       # (B, 91)
        avail = col & ~used
        i = avail.to(torch.int8).argmax(dim=1)      # first free row with bit
        found = avail.any(dim=1, keepdim=True)
        pivot = (rows == i[:, None]) & found
        elim = col & found & ~pivot
        a ^= torch.where(elim[..., None], a[take, i][:, None, :], 0)
        used |= pivot
        pcol = torch.where(pivot, j, pcol)
    return a, pcol


def reduce_basis_from_order_plain(order: torch.Tensor, tables
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the permute-pack, then the
    elimination."""
    return reduce_basis_batch_plain(_permute_pack(order, tables))


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    lib = kernel_library().lib
    lib.ft8_osd_reduce.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.ft8_osd_reduce.restype = ctypes.c_int
    lib.ft8_osd_table_words.argtypes = []
    lib.ft8_osd_table_words.restype = ctypes.c_int
    if lib.ft8_osd_table_words() != TABLE_WORDS:
        raise RuntimeError(f"the kernel's table has "
                           f"{lib.ft8_osd_table_words()} words, the "
                           f"wrapper's {TABLE_WORDS}")
    lib.ft8_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    return lib


def reduce_basis_from_order(order: torch.Tensor, tables
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reliability orders (B, 174) int64 (each row a permutation of
    0..173, as ``torch.sort`` gives it) -> (reduced bases (B, 91, 6) int32,
    pivot columns (B, 91) int32), as
    :func:`reduce_basis_from_order_plain`.  ``tables``: the
    ``ops.osd.OSDTables`` on the device of ``order``.

    A CPU tensor goes through the plain version; a CUDA tensor through the
    CUDA kernel, all rows in one launch (a build or launch failure raises).
    """
    if order.dim() != 2 or order.shape[1] != _N \
            or order.dtype != torch.int64:
        raise ValueError(f"order must be (B, {_N}) int64, got "
                         f"{tuple(order.shape)} {order.dtype}")
    rows = order.shape[0]
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} rows > {_MAX_ROWS}")
    if order.device.type == "cpu":
        return reduce_basis_from_order_plain(order, tables)
    if order.device.type != "cuda":
        raise ValueError(f"no kernel for device {order.device}")
    table = tables.basis_cols
    if tuple(table.shape) != (TABLE_WORDS,) or table.dtype != torch.int32 \
            or table.device != order.device or not table.is_contiguous():
        raise ValueError(f"table {tuple(table.shape)} {table.dtype} on "
                         f"{table.device}: want ({TABLE_WORDS},) int32 "
                         f"contiguous on {order.device}")
    out = torch.empty((rows, _K, _W), dtype=torch.int32, device=order.device)
    pcol = torch.empty((rows, _K), dtype=torch.int32, device=order.device)
    if rows == 0:
        return out, pcol
    lib = _library()
    order = order.contiguous()
    with torch.cuda.device(order.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ft8_osd_reduce(order.data_ptr(), table.data_ptr(),
                                 out.data_ptr(), pcol.data_ptr(), rows,
                                 stream)
    if err != 0:
        raise RuntimeError("osd_eliminate launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())
    count("k4.launches")
    return out, pcol
