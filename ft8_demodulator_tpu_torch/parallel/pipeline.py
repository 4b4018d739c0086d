"""Pipeline parallelism: the decode in two stages over a ``stage`` mesh.

Port of ``ft8_demodulator_tpu/parallel/pipeline.py``.  The cut is the LLR
boundary: stage 0 runs the grid-heavy front (waterfall -> the
frequency-major sync kernel K6 -> top-K -> LLR extraction) and stage 1 the
candidate-sized back (BP -> CRC -> payload pack, OSD with K4 under
``use_osd``).  The packet between them is the (K, 174) LLR matrix and four
candidate vectors (~14 KB a slot at K 20), not the (F, T) grid.

Stage 0 sends each microbatch's packet (``isend``) while it computes the
next; stage 1 receives them in order and finishes each; its stacked
results go to every rank of the mesh by one broadcast.  Left out: the
``lax.scan`` / ``lax.cond`` / ``pcast`` schedule (``:92-125``), which
expresses the two stages as one SPMD program (each process here runs its
own stage), and the float32 round trip of the result ``psum``
(``:125-128``): results travel as int32 (``collectives.pack_result``).
"""

from __future__ import annotations

import torch

from ..demod.decode import finish_decode
from ..demod.types import SlotDecodeResult
from ..ops.llr import extract_llrs
from ..ops.sync import find_candidates, search_grid
from ..ops.sync_cuda import sync_scores_kernel
from ..ops.waterfall import WaterfallParams, waterfall_real
from ..protocol import constants as C
from ..utils.device import entry_device
from . import collectives as col
from .mesh import axis

__all__ = ["decode_slots_pipelined"]


def _pack_packet(llrs, abs_time, abs_freq, score, valid) -> torch.Tensor:
    """The front's outputs -> one (K, 174 + 4) int32 packet (float32 bits
    as int32)."""
    i32 = lambda t: t.to(torch.int32)
    return torch.cat([llrs.view(torch.int32), torch.stack(
        [i32(abs_time), i32(abs_freq), score.view(torch.int32), i32(valid)],
        dim=-1)], dim=-1)


def _unpack_packet(packet: torch.Tensor):
    n = C.LDPC_N
    tail = lambda j: packet[:, n + j].contiguous()
    return (packet[:, :n].contiguous().view(torch.float32), tail(0),
            tail(1), tail(2).view(torch.float32), tail(3).bool())


def decode_slots_pipelined(waves, p: WaterfallParams, num_frames: int, mesh,
                           max_candidates: int = 20, min_score: float = 10.0,
                           max_iterations: int = 20, use_osd: bool = False,
                           device: str | torch.device = "cuda"
                           ) -> SlotDecodeResult | None:
    """(M, n) microbatches of slots -> stacked SlotDecodeResult (M, K, ...)
    (``pipeline.py:51``).

    ``mesh`` must have a 2-rank ``stage`` dimension.  ``waves`` (numpy or
    a tensor) is the same on both ranks; stage 0 uses it, on ``device``
    (the card unless the caller asks for the CPU).  Both ranks return the
    same result, which equals a per-slot decode; a rank outside the mesh
    returns None.
    """
    _, stage, n_stage = axis(mesh, "stage")
    if mesh is None or n_stage != 2:
        raise ValueError("decode_slots_pipelined wants a 2-stage mesh")
    device = entry_device(device)
    if stage is None:
        return None
    k = max_candidates
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    m = len(waves)
    empty = torch.empty((m, k, col.RESULT_COLS), dtype=torch.int32,
                        device=device)
    if stage == 0:
        waves = torch.as_tensor(waves, dtype=torch.float32, device=device)
        waits = []
        for wave in waves:
            mag = waterfall_real(wave, p, num_frames)
            scores = sync_scores_kernel(mag, g)
            abs_time, abs_freq, score, valid = find_candidates(
                scores, g, k, float(min_score))
            llrs = extract_llrs(mag, abs_time, abs_freq, g.time_osr,
                                g.freq_osr, g.num_blocks)
            waits.append(col.isend(_pack_packet(
                llrs, abs_time, abs_freq, score, valid), mesh, "stage", 1))
        for wait in waits:
            wait()
        packed = empty
    else:
        like = torch.empty((k, C.LDPC_N + 4), dtype=torch.int32,
                           device=device)
        packed = torch.stack([col.pack_result(finish_decode(
            *_unpack_packet(col.recv(like, mesh, "stage", 0)),
            max_iterations, use_osd)) for _ in range(m)]) \
            if m else empty
    return col.unpack_result(col.broadcast(packed, mesh, "stage", 1))
