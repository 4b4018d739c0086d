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
The kernel stages each block's tile of the grid in shared memory (cp.async)
and sums difference planes: D (the frequency pair), built there, and P
(the previous / next symbol), formed in registers from the staged grid,
one add per term; the source's header note has the design.  It computes
the validity masks from the search grid, reads the grid through its
strides (a cropped view needs no copy) and adds the terms in the order of
the plain versions, with every add rounded on its own, so its scores equal
:func:`ops.sync.sync_scores_tf` / :func:`ops.sync.sync_scores` bit for bit.
:func:`sync_scores_tf_planes` is the kernel's plane arithmetic in plain
PyTorch, for the tests (it holds the identities against JAX on the CPU);
no decode path calls it.

The osr 2x2 and 4x4 are compile-time instances; any other osr runs the
same code with the osr read at run time, on the widest tile that fits a
block's 227 KB of shared memory (fewer frequency lanes first, then fewer
start times a thread).  An osr that fits no tile (at osr n x n:
frequency-major from n = 18, time-major from n = 20; :func:`sync_tile`
says) raises a ValueError before any launch.

Each wrapper takes its plain version for a CPU tensor; for a CUDA tensor
it launches the kernel or raises, and counts the launch in the counter
``k5.launches`` (time-major) or ``k6.launches`` (frequency-major;
``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..protocol import constants as C
from ..utils.profiling import count
from .sync import SearchGrid, cell_mask_tensors, sync_scores, sync_scores_tf

__all__ = ["sync_scores_tf_kernel", "sync_scores_kernel",
           "sync_scores_tf_planes", "sync_tile"]

# grid dimension z of the launch is the batch
_MAX_BATCH = 65535
_MAX_INT = 2 ** 31 - 1
# a block's threads and the shared memory it may use (csrc/sync_stencil.cu)
_THREADS = 256
_MAX_SMEM = 227 * 1024


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    lib = kernel_library().lib
    lib.ft8_sync_scores.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ft8_sync_scores.restype = ctypes.c_int
    lib.ft8_sync_tile.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.ft8_sync_tile.restype = ctypes.c_int
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


def sync_tile(time_major: bool, time_osr: int, freq_osr: int
              ) -> tuple[int, int, int]:
    """(start times a thread, frequency lanes, shared-memory bytes) of a
    block of the sync kernel at this osr and layout.  Raises a ValueError
    that names the limit if no tile fits (builds the kernels)."""
    out = [ctypes.c_int() for _ in range(3)]
    err = _library().ft8_sync_tile(int(time_major), time_osr, freq_osr,
                                   *(ctypes.byref(v) for v in out))
    cells, lanes, smem = (v.value for v in out)
    if err == 0:
        return cells, lanes, smem
    layout = "time-major" if time_major else "frequency-major"
    if time_osr < 1 or freq_osr < 1 or time_osr > _THREADS:
        raise ValueError(f"osr {time_osr}x{freq_osr}: the sync kernel takes "
                         f"1 <= time_osr <= {_THREADS} (threads a block) "
                         "and freq_osr >= 1")
    raise ValueError(f"osr {time_osr}x{freq_osr} {layout}: the sync kernel's"
                     f" smallest tile ({cells} start time(s) a thread, "
                     f"{lanes} frequency lane(s)) needs {smem} bytes of "
                     f"shared memory, above the {_MAX_SMEM} (227 KB) a block"
                     " may use")


def _launch(grid: torch.Tensor, g: SearchGrid, time_major: bool
            ) -> torch.Tensor:
    """Launch the stencil on ``grid`` (..., T, F) or (..., F, T)."""
    sync_tile(time_major, g.time_osr, g.freq_osr)
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
    count("k5.launches")
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
    count("k6.launches")
    return out


def sync_scores_tf_planes(mag_tf: torch.Tensor,
                          g: SearchGrid) -> torch.Tensor:
    """The kernel's plane arithmetic in plain PyTorch: time-major (..., T,
    F) -> scores (..., num_times, num_freqs), bit for bit as
    :func:`ops.sync.sync_scores_tf`.

    On the zero-padded grid G: H(r, x) = G[r, x] - G[r, x + phi],
    D(r, x) = H(r, x) - H(r, x - phi), P(r, x) = G[r, x] - G[r - tau, x].
    Per cell, in the plain order: + D at the Costas cell (+ H at tone 0),
    + P(fr) for the previous symbol, - P(fr + tau) for the next one, each
    where its mask holds; then the reciprocal multiply.  One padded grid
    (no pre-roll split), as the kernel reads it (which keeps D in shared
    memory and forms P in registers from the same staged values).  Used
    only by the tests.
    """
    tau, phi = g.time_osr, g.freq_osr
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times + (C.NUM_SYMBOLS - 1) * tau
                - mag_tf.shape[-2])
    grid = F.pad(mag_tf, (0, 0, left, right))[..., : g.num_freqs + 7 * phi]
    h = grid[..., :-phi] - grid[..., phi:]             # H at x
    d = h[..., phi:] - h[..., :-phi]                   # D at x + phi
    p = grid[..., tau:, :] - grid[..., :-tau, :]       # P at r + tau
    cell_m, prev_m, next_m = (m[:, :, None] for m in
                              cell_mask_tensors(g, mag_tf.device))

    def at(plane, row, col):
        return plane[..., row: row + g.num_times, col: col + g.num_freqs]

    total = mag_tf.new_zeros((*mag_tf.shape[:-2], g.num_times, g.num_freqs))
    count = mag_tf.new_zeros((g.num_times, 1))
    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            r = left + g.t_start + (m * C.SYNC_SEQ_STRIDE + k) * tau
            tone = int(C.COSTAS_PATTERN[k])
            if tone == 0:
                freq, n_freq = at(h, r, 0), 1
            else:
                freq, n_freq = at(d, r, (tone - 1) * phi), 2
            total = torch.where(cell_m[i], total + freq, total)
            count += cell_m[i].float() * n_freq
            if k > 0:
                total = torch.where(prev_m[i],
                                    total + at(p, r - tau, tone * phi), total)
                count += prev_m[i].float()
            if k < C.COSTAS_LEN - 1:
                total = torch.where(next_m[i],
                                    total - at(p, r, tone * phi), total)
                count += next_m[i].float()
    inv = 1.0 / torch.clamp(count, min=1.0)
    return torch.where(count > 0, total * inv, -torch.inf)


# the kernel hard-codes the Costas geometry
assert (C.NUM_COSTAS_SEQS, C.COSTAS_LEN, C.SYNC_SEQ_STRIDE) == (3, 7, 36)
assert tuple(int(c) for c in C.COSTAS_PATTERN) == (3, 1, 4, 0, 6, 5, 2)
