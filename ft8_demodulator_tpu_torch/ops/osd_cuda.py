"""OSD on the card: the whole search, or the reduced bases alone.

Counterpart of the TPU kernel in ``ft8_demodulator_tpu/ops/osd.py:276``
(the ``pallas_call`` of ``_reduce_basis_pallas_batch``, :189), of the
permute-pack that feeds it (``_permute_pack``, :90) and of the search
around it (``_osd_tail``, :313).  The CUDA source ``csrc/osd_eliminate.cu``
(K4) has two entries, one warp per row; its header note has the design:

* :func:`osd_kernel`: LLRs and a need mask in, each needed row's OSD
  codeword and accept flag out, in one launch: the stable reliability sort,
  the permuted basis and its GF(2) elimination, the order-0/1/2/3 search
  with its CRC and gate, the winner in natural bit order.  ``ops/osd.py``
  runs it for every OSD call on a CUDA tensor; its plain version is the
  CPU route there (``_osd_rows``).
* :func:`reduce_basis_from_order`: reliability orders in, reduced bases and
  pivot columns out (the elimination alone).  Its plain version,
  :func:`reduce_basis_from_order_plain`, is the CPU route's elimination.

What bounds both on the card: each row's chain of dependent steps on one
warp (the elimination's ~100 pivot steps; in the fused kernel also the
ranking and the search's sums), so the kernels want many rows in flight;
``ops/osd.py`` hands the fused kernel all of an OSD call's rows in one
launch.

A basis is (91, 6) 32-bit words, held here as int32 (the kernel reads the
same bits as uint32): bit j of row k is bit j % 32 of word j // 32; code
columns 0..173 come in the candidate's reliability order and bits
174..187 carry each row's CRC syndrome.  :func:`_permute_pack` builds it
from the order; :func:`reduce_basis_batch_plain` is the elimination's
arithmetic (the JAX package's ``_reduce_basis_packed``, batched over
candidates).  Both entries count their launches in ``k4.launches``
(``utils/profiling.py``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..protocol import constants as C
from ..utils.profiling import count

__all__ = ["osd_kernel", "check_kernel_orders", "reduce_basis_from_order",
           "reduce_basis_from_order_plain", "reduce_basis_batch_plain",
           "MAX_ORDER2"]

_N, _K = C.LDPC_N, C.LDPC_K
_W = (_N + 31) // 32          # 6 words per 174-bit row (+ syndrome bits)
_GROUPS = (_K + 31) // 32     # 32-bit words of a column's row bits
TABLE_WORDS = _GROUPS * _N + _K
_MAX_ROWS = 2 ** 31 - 1       # the C entry takes the count as an int
MAX_ORDER2 = 32               # the fused search's limit (one row a lane)


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
    lib.ft8_osd_decode.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.ft8_osd_decode.restype = ctypes.c_int
    for name, want in (("ft8_osd_table_words", TABLE_WORDS),
                       ("ft8_osd_max_order2", MAX_ORDER2)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{name}: the kernel's {fn()}, the "
                               f"wrapper's {want}")
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


def check_kernel_orders(order2: int, order3: int) -> None:
    """Raise ValueError where the fused search's compile-time limits do not
    take (order2, order3)."""
    if not 0 <= order3 <= order2 <= MAX_ORDER2:
        raise ValueError(f"the card's OSD search takes 0 <= order3 <= order2"
                         f" <= {MAX_ORDER2}, got order2 {order2}, order3 "
                         f"{order3}")


def osd_kernel(llr: torch.Tensor, need: torch.Tensor | None, tables,
               lam: float, order2: int, order3: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, 174) float32 LLRs on a card and their (R,) bool need mask (None:
    every row) -> (plain (R, 174) int32, ok (R,) bool), one launch: each
    needed row's OSD as ``ops/osd.py``'s CPU route decides it (order3 < 3
    searches no triples), the others (zeros, False).  ``tables``: the
    ``ops.osd.OSDTables`` of the card.  Counts the launch in
    ``k4.launches``; raises for what the kernel does not take.
    """
    check_kernel_orders(order2, order3)
    rows = llr.shape[0]
    if llr.dim() != 2 or llr.shape[1] != _N or llr.dtype != torch.float32 \
            or llr.device.type != "cuda" or rows > _MAX_ROWS:
        raise ValueError(f"llr must be (R <= {_MAX_ROWS}, {_N}) float32 on a"
                         f" card, got {tuple(llr.shape)} {llr.dtype} on "
                         f"{llr.device}")
    if need is not None and (need.shape != (rows,) or need.dtype != torch.bool
                             or need.device != llr.device):
        raise ValueError(f"need must be ({rows},) bool on {llr.device}, got "
                         f"{tuple(need.shape)} {need.dtype} on {need.device}")
    table = tables.basis_cols
    if table.device != llr.device:
        raise ValueError(f"table on {table.device}, LLRs on {llr.device}")
    plain = torch.empty((rows, _N), dtype=torch.int32, device=llr.device)
    ok = torch.empty((rows,), dtype=torch.bool, device=llr.device)
    if rows == 0:
        return plain, ok
    lib = _library()
    llr = llr.contiguous()
    if need is not None:
        need = need.contiguous()
    need_ptr = None if need is None else need.data_ptr()
    with torch.cuda.device(llr.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ft8_osd_decode(llr.data_ptr(), need_ptr, table.data_ptr(),
                                 plain.data_ptr(), ok.data_ptr(), rows, lam,
                                 order2, order3, stream)
    if err != 0:
        raise RuntimeError("osd_decode launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())
    count("k4.launches")
    return plain, ok
