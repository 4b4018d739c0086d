"""GF(2) elimination of packed OSD bases on the card.

Counterpart of the TPU kernel in ``ft8_demodulator_tpu/ops/osd.py:212``
(``_reduce_basis_pallas_batch``, :189).  The CUDA kernel
``csrc/osd_eliminate.cu`` gives each candidate one warp, with the 91 basis
rows in registers (three per lane); its header note has the design.

What bounds it on the card: the chain of up to 174 dependent pivot steps
per candidate (a candidate is only 2.2 KB in and 2.5 KB out), so the
kernel wants many candidates in flight; the DEEP decode hands it ~10 k
rows per BP group.

A basis is (91, 6) 32-bit words, held here as int32 (the kernel reads the
same bits as uint32): bit j of row k is bit j % 32 of word j // 32; code
columns 0..173 come in the candidate's reliability order and bits
174..187 carry each row's CRC syndrome.
:func:`reduce_basis_batch_plain` is the plain PyTorch version (the JAX
package's ``_reduce_basis_packed``, batched over candidates), and the
kernel equals it bit for bit.  :func:`reduce_basis_batch` takes the plain
version for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.  Its ``launches`` attribute counts kernel launches and ``rows``
the candidates those launches reduced.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..protocol import constants as C

__all__ = ["reduce_basis_batch", "reduce_basis_batch_plain"]

_N, _K = C.LDPC_N, C.LDPC_K
_W = (_N + 31) // 32          # 6 words per 174-bit row (+ syndrome bits)
_MAX_ROWS = 2 ** 31 - 1       # the C entry takes the count as an int


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


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    lib = kernel_library().lib
    lib.ft8_osd_eliminate.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.ft8_osd_eliminate.restype = ctypes.c_int
    lib.ft8_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    return lib


def reduce_basis_batch(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed bases (B, 91, 6) int32 -> (reduced (B, 91, 6) int32, pivot
    columns (B, 91) int32), as :func:`reduce_basis_batch_plain`.

    A CPU tensor goes through the plain version; a CUDA tensor through the
    CUDA kernel (a build or launch failure raises).
    """
    if a.dim() != 3 or tuple(a.shape[1:]) != (_K, _W) \
            or a.dtype != torch.int32:
        raise ValueError(f"bases must be (B, {_K}, {_W}) int32, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.shape[0] > _MAX_ROWS:
        raise ValueError(f"{a.shape[0]} bases > {_MAX_ROWS}")
    if a.device.type == "cpu":
        return reduce_basis_batch_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")

    lib = _library()
    a = a.contiguous()
    out = torch.empty_like(a)
    pcol = torch.empty(a.shape[:2], dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ft8_osd_eliminate(a.data_ptr(), out.data_ptr(),
                                    pcol.data_ptr(), a.shape[0], stream)
    if err != 0:
        raise RuntimeError("osd_eliminate launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())
    reduce_basis_batch.launches += 1
    reduce_basis_batch.rows += a.shape[0]
    return out, pcol


reduce_basis_batch.launches = 0
reduce_basis_batch.rows = 0
