"""Soft-symbol LLRs of candidate rows, on the card: the kernel K8.

The CUDA kernel ``csrc/llr_gather.cu`` gathers each candidate's (58 data
symbols x 8 tones) cells, reorders them through the Gray map, forms the
174 max-of-4 bit LLRs, zeroes the symbols outside the grid and scales the
row to variance 24, one warp a row and one launch a call; its header note
has the design.  It serves both routes of ``ops/llr.py`` on a CUDA tensor:
the Hann route (:func:`ops.llr.extract_llrs_tf`, and
:func:`ops.llr.extract_llrs` through its transposed view) and the boxcar
route (:func:`ops.llr.extract_llrs_matched_grid`).  It replaces no TPU
kernel: the JAX package reads these cells through one-hot matmuls.

What bounds it on the card: bytes (:func:`llr_bound`); the plain version
(``ops/llr.py`` ``_hann_llrs_plain`` / ``_grid_llrs_plain``, then
``normalize_llrs``) is ~45 small launches a call.  :func:`llr_kernel`
launches the kernel on a CUDA tensor or raises, and counts the launch in
``k8.launches`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..protocol import constants as C
from ..utils.profiling import count

__all__ = ["llr_kernel", "llr_bound"]

_N = C.LDPC_N
_DATA = C.NUM_DATA_SYMBOLS
_MAX_INT = 2 ** 31 - 1                      # the C entry takes ints


def llr_bound(rows: int) -> float:
    """Seconds the card needs at least to extract ``rows`` rows: each row's
    58 x 8 float32 cells and two int32 coordinates read once, its 174
    float32 LLRs written once, at 3.35 TB/s."""
    return rows * (_DATA * 8 * 4 + 2 * 4 + _N * 4) / 3.35e12


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    lib = kernel_library().lib
    lib.ft8_llr_extract.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
        + [ctypes.c_void_p] * 3)
    lib.ft8_llr_extract.restype = ctypes.c_int
    lib.ft8_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    return lib


def llr_kernel(grid: torch.Tensor, abs_time: torch.Tensor,
               abs_freq: torch.Tensor, time_osr: int, freq_osr: int,
               num_blocks: int, matched: bool, gray_map: torch.Tensor
               ) -> torch.Tensor:
    """Grid (..., T, F) float32 on a card, any strides + candidates
    (..., K) integer -> LLRs (..., K, 174) float32, each row scaled to
    variance 24, one launch (none for 0 rows).

    ``matched`` False: the dB grid's Hann LLRs (symbols outside
    ``num_blocks`` blocks give 0); True: the boxcar power grid's matched
    LLRs (rows outside the grid read power 0; ``num_blocks`` unread).
    ``gray_map``: (8,) integer tones on the same card (the caller's
    ``protocol/tables.py`` copy).  Candidates are read as int32.
    A bad argument (a grid of more than 2^31 - 1 cells a slot among them)
    or a refused launch raises.
    """
    if grid.dim() < 2 or grid.dtype != torch.float32:
        raise ValueError(f"grid must be (..., T, F) float32, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    lead, (frames, bins) = grid.shape[:-2], grid.shape[-2:]
    if abs_time.shape != abs_freq.shape or abs_time.shape[:-1] != lead \
            or abs_time.dim() != len(lead) + 1:
        raise ValueError(f"candidates {tuple(abs_time.shape)} / "
                         f"{tuple(abs_freq.shape)} do not match the grid's "
                         f"lead {tuple(lead)}")
    if abs_time.dtype.is_floating_point or abs_freq.dtype.is_floating_point \
            or abs_time.is_complex() or abs_freq.is_complex():
        raise ValueError(f"candidates must be integers, got "
                         f"{abs_time.dtype} / {abs_freq.dtype}")
    if not (1 <= time_osr <= _MAX_INT and 1 <= freq_osr <= _MAX_INT
            and abs(num_blocks) <= _MAX_INT):
        raise ValueError(f"osr {time_osr}x{freq_osr}, {num_blocks} blocks")
    if tuple(gray_map.shape) != (8,):
        raise ValueError(f"gray_map must be (8,), got "
                         f"{tuple(gray_map.shape)}")
    if frames * bins > _MAX_INT:            # the kernel divides in 32 bits
        raise ValueError(f"grid {tuple(grid.shape)}: more than 2^31 - 1 "
                         "cells a slot")
    if grid.device.type != "cuda":
        raise ValueError(f"no kernel for device {grid.device}")
    dev = grid.device
    if abs_time.device != dev or abs_freq.device != dev \
            or gray_map.device != dev:
        raise ValueError(f"candidates on {abs_time.device} / "
                         f"{abs_freq.device}, grid on {dev}")
    k = abs_time.shape[-1]
    rows = abs_time.numel()
    out = torch.empty((*lead, k, _N), dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    if frames == 0 or bins == 0 or rows > _MAX_INT:
        raise ValueError(f"grid {tuple(grid.shape)}, {rows} rows")
    cells = grid.reshape(-1, frames, bins)
    at = abs_time.to(torch.int32).contiguous()
    af = abs_freq.to(torch.int32).contiguous()
    gray = gray_map.to(torch.int64).contiguous()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ft8_llr_extract(
            cells.data_ptr(), *cells.stride(), frames, bins, at.data_ptr(),
            af.data_ptr(), k, rows, time_osr, freq_osr, num_blocks,
            int(matched), gray.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("llr_gather launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())
    count("k8.launches")
    return out
