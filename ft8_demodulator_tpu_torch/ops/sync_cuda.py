"""The Costas sync stencil on the card, time-major and frequency-major.

Counterpart of the two TPU stencil kernels of the JAX package.  One CUDA
source, ``csrc/sync_stencil.cu``, holds both as instances of one template:

* :func:`sync_scores_tf_kernel` (grid (..., T, F) -> scores (...,
  num_times, num_freqs)) replaces ``ops/sync_pallas_tf.py:162`` ``_kernel``
  (entry ``sync_scores_tf_pallas`` :190); the slot decoders
  (``decode_slots``, ``decode_slot``) score through it;
* :func:`sync_scores_kernel` (grid (..., F, T) -> scores (..., num_freqs,
  num_times)) replaces ``ops/sync_pallas.py:154`` ``_sync_kernel`` (entry
  ``sync_scores_padded`` :189 / ``sync_scores_pallas`` :241); the host API
  (``decode_waterfall``, ``decode_waterfall_mf``) scores through it.

The outputs are not padded (the TPU kernels pad to 128 lanes for VMEM).
What bounds the kernel on the card: ~100 reads per score cell, served
from L1/L2 (a batch of grids fits in the 50 MB L2); the source's header
note has the design.  The kernel computes the validity masks from the
search grid, reads the grid through its strides (a cropped view needs no
copy) and adds the terms in the order of the plain versions, with every
add rounded on its own, so its scores equal
:func:`ops.sync.sync_scores_tf` / :func:`ops.sync.sync_scores` bit for bit.

Each wrapper takes its plain version for a CPU tensor; for a CUDA tensor
it launches the kernel or raises.  Its ``launches`` attribute counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..protocol import constants as C
from .sync import SearchGrid, sync_scores, sync_scores_tf

__all__ = ["sync_scores_tf_kernel", "sync_scores_kernel"]

# grid dimension z of the launch is the batch
_MAX_BATCH = 65535
_MAX_INT = 2 ** 31 - 1


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    lib = kernel_library().lib
    lib.ft8_sync_scores.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ft8_sync_scores.restype = ctypes.c_int
    lib.ft8_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(grid: torch.Tensor, g: SearchGrid, num_bins: int) -> None:
    if grid.dim() < 2 or grid.dtype != torch.float32:
        raise ValueError(f"grid must be (..., 2-D) float32, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    if g.num_freqs > 0 and num_bins < g.num_freqs + 7 * g.freq_osr:
        raise ValueError(f"{num_bins} bins < num_freqs {g.num_freqs} + 7 * "
                         f"freq_osr {g.freq_osr}")


def _launch(grid: torch.Tensor, g: SearchGrid, time_major: bool
            ) -> torch.Tensor:
    """Launch the stencil on ``grid`` (..., T, F) or (..., F, T)."""
    lead = grid.shape[:-2]
    flat = grid.reshape(-1, *grid.shape[-2:])     # a view for cropped grids
    batch = flat.shape[0]
    if batch > _MAX_BATCH:
        raise ValueError(f"batch {batch} > {_MAX_BATCH}")
    if time_major:
        num_frames = flat.shape[1]
        sb, st, sf = flat.stride()
        shape = (g.num_times, g.num_freqs)
    else:
        num_frames = flat.shape[2]
        sb, sf, st = flat.stride()
        shape = (g.num_freqs, g.num_times)
    if max(num_frames, g.num_times, g.num_freqs) > _MAX_INT:
        raise ValueError("grid too large for the kernel's int indices")
    out = torch.empty((batch, *shape), dtype=torch.float32,
                      device=grid.device)
    lib = _library()
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ft8_sync_scores(
            flat.data_ptr(), out.data_ptr(), int(time_major), batch, sb, st,
            sf, num_frames, g.time_osr, g.freq_osr, g.num_blocks, g.t_start,
            g.num_times, g.num_freqs, stream)
    if err != 0:
        raise RuntimeError("sync_stencil launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())
    return out.reshape(*lead, *shape)


def sync_scores_tf_kernel(mag_tf: torch.Tensor,
                          g: SearchGrid) -> torch.Tensor:
    """Time-major waterfall (..., T, F) f32 -> scores (..., num_times,
    num_freqs), as :func:`ops.sync.sync_scores_tf`.

    A CPU tensor goes through the plain version; a CUDA tensor through the
    CUDA kernel (a build or launch failure raises).
    """
    _check(mag_tf, g, mag_tf.shape[-1])
    if mag_tf.device.type == "cpu":
        return sync_scores_tf(mag_tf, g)
    if mag_tf.device.type != "cuda":
        raise ValueError(f"no kernel for device {mag_tf.device}")
    out = _launch(mag_tf, g, time_major=True)
    sync_scores_tf_kernel.launches += 1
    return out


def sync_scores_kernel(mag: torch.Tensor, g: SearchGrid) -> torch.Tensor:
    """Frequency-major waterfall (..., F, T) f32 -> scores (...,
    num_freqs, num_times), as :func:`ops.sync.sync_scores`.

    Any strides: a frequency or time crop of a grid is read in place.  A
    CPU tensor goes through the plain version; a CUDA tensor through the
    CUDA kernel (a build or launch failure raises).
    """
    _check(mag, g, mag.shape[-2])
    if mag.device.type == "cpu":
        return sync_scores(mag, g)
    if mag.device.type != "cuda":
        raise ValueError(f"no kernel for device {mag.device}")
    out = _launch(mag, g, time_major=False)
    sync_scores_kernel.launches += 1
    return out


sync_scores_tf_kernel.launches = 0
sync_scores_kernel.launches = 0

# the kernel hard-codes the Costas geometry
assert (C.NUM_COSTAS_SEQS, C.COSTAS_LEN, C.SYNC_SEQ_STRIDE) == (3, 7, 36)
assert tuple(int(c) for c in C.COSTAS_PATTERN) == (3, 1, 4, 0, 6, 5, 2)
