"""The candidate top-K on the card: the kernel K9.

The CUDA kernel ``csrc/topk_select.cu`` takes a sync score grid (...,
num_times, num_freqs) through its strides and returns the K candidates of
:func:`ops.sync.find_candidates_tf`'s plain route bit for bit: the row
screen (the K + 12 frequencies with the largest maxima over time, ties to
the lower frequency) and the flat selection over the screened rows in
screen order (or over the whole grid where it has no more than K + 12
frequencies), one thread block a slot and one launch a call; its header
note has the design.  It serves :func:`ops.sync.find_candidates_tf` on a
CUDA tensor, and :func:`ops.sync.find_candidates` through its transposed
view.  It replaces no TPU kernel: the JAX package selects with
``lax.top_k``.

What bounds it on the card: bytes (:func:`topk_bound`); the plain route is
about twenty small launches and two stable radix sorts a call.
:func:`topk_kernel` launches the kernel on a CUDA tensor or raises, and
counts the launch in ``k9.launches`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils.profiling import count

__all__ = ["topk_kernel", "topk_bound"]

MAX_K = 1024                  # candidates a slot (csrc/topk_select.cu)
MAX_SCREEN_FREQS = 32768      # frequencies a screened grid may have
_ROW_SLACK = 12               # ops/sync.py _ROW_SLACK
_MAX_INT = 2 ** 31 - 1        # the kernel's indices are 32-bit


def topk_bound(slots: int, num_times: int, num_freqs: int, k: int) -> float:
    """Seconds the card needs at least to select ``k`` candidates in each
    of ``slots`` grids: each float32 score read once and 13 bytes written a
    candidate, at 3.35 TB/s."""
    return slots * (num_times * num_freqs * 4 + k * 13) / 3.35e12


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    lib = kernel_library().lib
    lib.ft8_topk_select.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 5)
    lib.ft8_topk_select.restype = ctypes.c_int
    lib.ft8_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lead_stride(scores: torch.Tensor) -> int:
    """The stride from one slot to the next over the lead dimensions read
    as one, or a ValueError where they do not step at one stride."""
    dims = [(size, stride) for size, stride in zip(scores.shape[:-2],
                                                   scores.stride()[:-2])
            if size != 1]
    for (_, outer), (size, inner) in zip(dims, dims[1:]):
        if outer != inner * size:
            raise ValueError(f"lead {tuple(scores.shape[:-2])} at strides "
                             f"{tuple(scores.stride()[:-2])} does not step "
                             "at one stride")
    return dims[-1][1] if dims else 0


def topk_kernel(scores_tf: torch.Tensor, num_times: int, t_start: int,
                max_candidates: int, min_score: float):
    """Time-major scores (..., num_times, num_freqs) float32 on a card, any
    strides -> (abs_time int32, abs_freq int32, score float32, valid bool),
    each (..., M): M = max_candidates where the grid is screened
    (num_freqs > max_candidates + 12), else min(max_candidates, cells).
    The four are views of one allocation (``valid`` steps 4 M bytes from
    slot to slot); one launch (none for an empty grid or lead).
    ``num_times`` is the search grid's, which the grid's must equal.  A bad
    argument (K outside 1..1,024, a screened grid of more than 32,768
    frequencies, 2^31 cells or more a slot, a lead that does not step at
    one stride) raises a ValueError before any launch; a refused launch
    raises a RuntimeError.
    """
    if scores_tf.dim() < 2 or scores_tf.dtype != torch.float32:
        raise ValueError(f"scores must be (..., T, F) float32, got "
                         f"{tuple(scores_tf.shape)} {scores_tf.dtype}")
    *lead, times, freqs = scores_tf.shape
    if times != num_times:
        raise ValueError(f"scores have {times} start times, the search "
                         f"grid {num_times}")
    if not 1 <= max_candidates <= MAX_K:
        raise ValueError(f"max_candidates {max_candidates}: the kernel "
                         f"takes 1 to {MAX_K}")
    screened = freqs > max_candidates + _ROW_SLACK and times > 0
    cells = (max_candidates + _ROW_SLACK if screened else freqs) * times
    if screened and freqs > MAX_SCREEN_FREQS:
        raise ValueError(f"{freqs} frequencies: the kernel screens at most "
                         f"{MAX_SCREEN_FREQS}")
    if cells > _MAX_INT:
        raise ValueError(f"scores {tuple(scores_tf.shape)}: 2^31 cells or "
                         "more a slot")
    if not -_MAX_INT <= t_start <= _MAX_INT - times:
        raise ValueError(f"t_start {t_start} beyond int32")
    s_lead = _lead_stride(scores_tf)
    slots = math.prod(lead)
    if slots > _MAX_INT:
        raise ValueError(f"{slots} slots")
    if scores_tf.device.type != "cuda":
        raise ValueError(f"no kernel for device {scores_tf.device}")
    m = max_candidates if screened else min(max_candidates, cells)
    # one block (4, *lead, m) of int32: abs_time, abs_freq, the scores'
    # bits, and each slot's valid flags in the first m bytes of its row
    buf = torch.empty((4, *lead, m), dtype=torch.int32,
                      device=scores_tf.device)
    abs_time, abs_freq, bits, flags = buf.unbind(0)
    out = (abs_time, abs_freq, bits.view(torch.float32),
           flags.view(torch.bool)[..., :m])
    if slots * m == 0:
        return out
    lib = _library()
    dev = scores_tf.device
    args = (scores_tf.data_ptr(), s_lead, *scores_tf.stride()[-2:], slots,
            times, freqs, max_candidates, min_score, t_start,
            abs_time.data_ptr(), abs_freq.data_ptr(), bits.data_ptr(),
            flags.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.ft8_topk_select(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.ft8_topk_select(*args)
    if err != 0:
        raise RuntimeError("topk_select launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())
    count("k9.launches")
    return out
