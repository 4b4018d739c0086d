"""Composed (channel x stream x freq) decoding: tensor parallelism inside
the sharded stream.

Port of ``ft8_demodulator_tpu/parallel/composed.py``: one decode over one
3-dimensional mesh.

* ``channel`` — independent receivers (data parallelism, no messages),
* ``stream`` — contiguous time blocks of each channel, with the one-frame
  overlap-save halo from the next stream coordinate (``streaming.py``),
* ``freq`` — each block's search grid in bands as in ``tensor.py``: band
  waterfalls, the sync kernel K6 on each band, a gathered top-K merge and
  the owner's LLRs summed.

Ranks that differ only in ``freq`` hold the same block, exchange the same
halo and end with the same rows, so the results are gathered over
``channel`` and ``stream`` only, never over ``freq`` (``:167-169``).  The
rows equal the (channel x stream) decoder's and so the one-rank path's.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..demod.decode import finish_decode
from ..demod.types import FT8Decode, SlotDecodeResult
from ..ops.waterfall import WaterfallParams, waterfall_params
from ..utils.device import entry_device
from .mesh import _mesh, axis
from .streaming import (_format_stream_results, _local_grid, _numpy,
                        _pad_capture, _preroll_rows, _stream_shards)
from .tensor import _band_front

__all__ = ["make_composed_mesh", "decode_stream_composed_sharded",
           "decode_stream_composed"]


def make_composed_mesh(channel: int = 1, stream: int = 1, freq: int = 1,
                       device: str | torch.device = "cuda") -> DeviceMesh:
    """The 3-dimensional (channel, stream, freq) mesh (``composed.py:47``)."""
    return _mesh((channel, stream, freq), ("channel", "stream", "freq"),
                 device, f"mesh {channel}x{stream}x{freq}")


def _decode_block_tp(extended: torch.Tensor, p: WaterfallParams,
                     block_frames: int, mesh, max_candidates: int,
                     min_score: float, max_iterations: int
                     ) -> SlotDecodeResult:
    """One stream block's row, its frequency grid in bands over ``freq``
    (``composed.py:60``): ``tensor.py``'s schedule on the block grid
    (start times [0, block) against the halo-extended view)."""
    ext_frames = p.num_frames(extended.shape[-1])
    g_full = _local_grid(p, block_frames, ext_frames)
    front = _band_front(extended, p, ext_frames, g_full, mesh,
                        max_candidates, min_score)
    return finish_decode(*front, max_iterations, False)


def decode_stream_composed_sharded(audio, p: WaterfallParams, mesh,
                                   max_candidates: int = 20,
                                   min_score: float = 10.0,
                                   max_iterations: int = 20,
                                   device: str | torch.device = "cuda"
                                   ) -> tuple[SlotDecodeResult,
                                              torch.Tensor] | None:
    """(channels, n_samples) -> (stacked SlotDecodeResult, yield)
    (``composed.py:121``).

    As ``streaming.decode_stream_sharded`` over a (channel, stream, freq)
    mesh: the audio splits over (channel, stream), each block's grid over
    freq.  Every rank of the mesh returns the same (channels, n_blocks, K,
    ...) results, equal to the (channel x stream) decoder's; a rank
    outside the mesh returns None.
    """
    block_frames = audio.shape[-1] // axis(mesh, "stream")[2] // p.hop

    def decode_row(block, halo):
        return _decode_block_tp(torch.cat([block, halo]), p, block_frames,
                                mesh, max_candidates, float(min_score),
                                max_iterations)

    return _stream_shards(audio, p, mesh, decode_row, entry_device(device))


def decode_stream_composed(audio, sample_rate: float, mesh,
                           bins_per_tone: int = 2,
                           steps_per_symbol: int = 2,
                           max_candidates: int = 20,
                           min_score: float = 10.0,
                           max_iterations: int = 20,
                           device: str | torch.device = "cuda"
                           ) -> list[FT8Decode] | None:
    """Host API over the composed mesh (``composed.py:187``): the rows of
    ``streaming.decode_stream`` (the same padding, pre-roll, formatting
    and dedup).  A rank outside the mesh returns None."""
    device = entry_device(device)
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    n_stream = axis(mesh, "stream")[2]
    audio = _pad_capture(audio, axis(mesh, "channel")[2], n_stream, p)
    out = decode_stream_composed_sharded(audio, p, mesh, max_candidates,
                                         float(min_score), max_iterations,
                                         device)
    if out is None:
        return None
    res, n_success = out
    pre_res = _preroll_rows(audio, p, max_candidates, min_score,
                            max_iterations, False, False, False, False,
                            device)
    return _format_stream_results(_numpy(res), pre_res, int(n_success), p,
                                  audio.shape[1] // n_stream // p.hop)
