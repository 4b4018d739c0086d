"""Sharded continuous-stream decoding with an overlap-save halo.

Port of ``ft8_demodulator_tpu/parallel/streaming.py``, the sequence- and
data-parallel path: a long capture is split into equal blocks over the
mesh's ``stream`` dimension and its channels over ``channel``.  Each block
needs one full FT8 frame (79 symbols) past its right edge so that a
transmission straddling a block edge decodes exactly once: the head of
block i+1 travels to rank i (``collectives.shift_left``, the JAX
``ppermute``).  Candidate start times are restricted to the local block,
so each message is owned by one rank; a final dedup on the host handles
the rare double decode of one transmission at slightly different offsets.

Every rank of the mesh holds the same full capture (as every JAX process
passes the same host audio), copies only its shard to its device, decodes
it there (the frequency-major sync kernel K6 once per channel row, the OSD
kernel K4 under ``use_osd``) with one ``SlotDecoder`` per geometry and
device (``demod/decode.py slot_decoder``), and the results are gathered
over ``stream`` and ``channel`` in mesh order, so every rank formats the
same rows.  The yield counter is a sum over both.

Left out of the JAX function: the ``lax.map`` chunking of wide channel
vmaps (``:184-196``, an XLA workaround: the port decodes a rank's rows one
by one) and the disjoint scatter + ``psum`` gather (``:206-214``, which
``shard_map``'s replication checker needs: the port gathers).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..demod.decode import (SlotDecoder, decode_waterfall,
                            decode_waterfall_mf, mf_retry, slot_decoder)
from ..demod.types import FT8Decode, FT8DecodeStatus, FT8Message, \
    SlotDecodeResult
from ..ops.sync import PRE_ROLL_SYMBOLS, SearchGrid
from ..ops.waterfall import WaterfallParams, waterfall_params, waterfall_real
from ..protocol import constants as C
from ..utils.device import entry_device
from . import collectives as col
from .mesh import axis, make_mesh

__all__ = ["stream_halo_samples", "decode_stream_sharded", "decode_stream"]


def stream_halo_samples(p: WaterfallParams) -> int:
    """Samples of right halo each block needs: one full frame + one
    symbol (``streaming.py:45``)."""
    return (C.NUM_SYMBOLS + 1) * p.nperseg


def _local_grid(p: WaterfallParams, block_frames: int,
                ext_frames: int) -> SearchGrid:
    """Search grid owning start times [0, block) against the extended view
    (``streaming.py:50``).

    The capture-start pre-roll is not part of it: :func:`_decode_preroll`
    decodes the start times t < 0 once per stream, so ownership stays
    disjoint (blocks own t >= 0)."""
    return SearchGrid(
        time_osr=p.time_osr, freq_osr=p.freq_osr,
        num_blocks=ext_frames // p.time_osr,
        t_start=0, num_times=block_frames,
        num_freqs=max(0, p.num_freq_bins - 7 * p.freq_osr),
    )


def _decode_wave(wave: torch.Tensor, p: WaterfallParams, g: SearchGrid,
                 max_candidates: int, min_score: float, max_iterations: int,
                 use_mf: bool, use_osd: bool, mf_first: bool,
                 mf_refine: bool, decoder: SlotDecoder) -> SlotDecodeResult:
    """One row's decode over grid ``g``: waterfall -> K6 -> top-K -> LLRs
    -> BP (+ OSD), or the MF-first decode, (+ the MF retry)."""
    mag = waterfall_real(wave, p, p.num_frames(wave.shape[-1]))
    if mf_first:
        return decode_waterfall_mf(mag, wave, p, g, 0, 0, max_candidates,
                                   min_score, max_iterations, use_osd,
                                   mf_refine=mf_refine, decoder=decoder)
    res = decode_waterfall(mag, g, max_candidates, min_score,
                           max_iterations, use_osd, decoder=decoder)
    if use_mf:
        res = mf_retry(wave, p, res, 0, 0, max_iterations, use_osd,
                       mf_refine=mf_refine, decoder=decoder)
    return res


def _decode_block(block: torch.Tensor, halo: torch.Tensor,
                  p: WaterfallParams, max_candidates: int, min_score: float,
                  max_iterations: int, use_mf: bool = False,
                  use_osd: bool = False, mf_first: bool = False,
                  mf_refine: bool = False) -> SlotDecodeResult:
    """One row of a rank's block: extend with the right halo, decode the
    locally owned start times (``streaming.py:70``) with the cached
    decoder of the block geometry on this rank's device."""
    extended = torch.cat([block, halo], dim=-1)
    ext_frames = p.num_frames(extended.shape[-1])
    g = _local_grid(p, block.shape[-1] // p.hop, ext_frames)
    return _decode_wave(extended, p, g, max_candidates, min_score,
                        max_iterations, use_mf, use_osd, mf_first, mf_refine,
                        slot_decoder(p, ext_frames, extended.device))


def _decode_preroll(audio, p: WaterfallParams, max_candidates: int,
                    min_score: float, max_iterations: int,
                    use_mf: bool = False, use_osd: bool = False,
                    mf_first: bool = False, mf_refine: bool = False,
                    device: str | torch.device = "cuda") -> SlotDecodeResult:
    """Decode only the pre-roll start times (t < 0) of the capture start
    (``streaming.py:103``): a transmission clipped at t = 0 decodes here
    as in the slot decoder's pre-roll scan.

    audio: (channels, w) leading slice, one frame past the scan; each row
    decodes on ``device`` (every rank of the mesh runs it: it is small).
    Returns (channels, K) results.
    """
    device = entry_device(device)
    audio = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    pre = PRE_ROLL_SYMBOLS * p.time_osr
    num_frames = p.num_frames(audio.shape[-1])
    g = SearchGrid(
        time_osr=p.time_osr, freq_osr=p.freq_osr,
        num_blocks=num_frames // p.time_osr,
        t_start=-pre, num_times=pre,
        num_freqs=max(0, p.num_freq_bins - 7 * p.freq_osr),
    )
    decoder = slot_decoder(p, num_frames, device)
    rows = [_decode_wave(wave, p, g, max_candidates, min_score,
                         max_iterations, use_mf, use_osd, mf_first,
                         mf_refine, decoder) for wave in audio]
    return SlotDecodeResult(*(torch.stack(f) for f in zip(*rows)))


def _stream_shards(audio, p: WaterfallParams, mesh, decode_row, device
                   ) -> tuple[SlotDecodeResult, torch.Tensor] | None:
    """The sharded stream's skeleton, shared with ``composed.py``: this
    rank's (rows, block) shard of the (channels, n_samples) capture, the
    halo from the next stream coordinate, ``decode_row(block, halo)`` on
    each row, and the results gathered over (stream, channel) and the
    yield summed over both.  None on a rank outside ``mesh``."""
    _, st, n_stream = axis(mesh, "stream")
    _, ch, n_channel = axis(mesh, "channel")
    if st is None:
        return None
    channels, n_samples = audio.shape
    block_len = n_samples // n_stream
    if block_len * n_stream != n_samples or block_len % p.hop \
            or channels % n_channel:
        raise ValueError(
            f"audio {tuple(audio.shape)}: the samples must split into "
            f"{n_stream} blocks of whole hops ({p.hop}) and the channels "
            f"into {n_channel} equal parts")
    rows = channels // n_channel
    local = torch.as_tensor(audio[ch * rows: (ch + 1) * rows,
                                  st * block_len: (st + 1) * block_len],
                            dtype=torch.float32, device=device)
    halo_len = min(stream_halo_samples(p), block_len)
    halo = col.shift_left(local[:, :halo_len], mesh, "stream")
    res = [decode_row(b, h) for b, h in zip(local, halo)]
    packed = torch.stack([col.pack_result(r) for r in res])   # (rows, K, 18)
    n_success = col.all_sum(
        packed[..., 0].sum(dtype=torch.int64), mesh, ("stream", "channel"))
    by_stream = col.gather(packed, mesh, "stream").transpose(0, 1)
    full = col.gather(by_stream.contiguous(), mesh, "channel")
    return col.unpack_result(full.flatten(0, 1)), n_success


def decode_stream_sharded(audio, p: WaterfallParams, mesh,
                          max_candidates: int = 20, min_score: float = 10.0,
                          max_iterations: int = 20, use_mf: bool = False,
                          use_osd: bool = False, mf_first: bool = False,
                          mf_refine: bool = False,
                          device: str | torch.device = "cuda"
                          ) -> tuple[SlotDecodeResult, torch.Tensor] | None:
    """(channels, n_samples) audio -> (stacked SlotDecodeResult, yield)
    (``streaming.py:151``).

    ``audio`` (numpy or a tensor) is the whole capture, the same on every
    rank of ``mesh`` (a (channel, stream) mesh; None: this process alone);
    n_samples must split into mesh.size("stream") blocks of whole hops and
    the channels into mesh.size("channel") parts.  Each rank decodes its
    shard on ``device`` (the card unless the caller asks for the CPU).
    Every rank of the mesh returns the same results, shaped (channels,
    n_blocks, K, ...), and the yield (successful rows before dedup) as a
    0-d int64 tensor; a rank outside the mesh returns None.
    """
    def decode_row(block, halo):
        return _decode_block(block, halo, p, max_candidates,
                             float(min_score), max_iterations, use_mf,
                             use_osd, mf_first, mf_refine)

    return _stream_shards(audio, p, mesh, decode_row, entry_device(device))


def _pad_capture(audio, n_channel: int, n_stream: int,
                 p: WaterfallParams) -> np.ndarray:
    """(n,) or (channels, n) -> float32 (channels', n') with the channels
    padded to a multiple of n_channel and the samples to n_stream equal
    blocks of whole hops (``streaming.py:271-281``)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    if audio.shape[0] % n_channel:
        reps = -(-audio.shape[0] // n_channel) * n_channel
        audio = np.pad(audio, ((0, reps - audio.shape[0]), (0, 0)))
    block = -(-audio.shape[1] // (n_stream * p.hop)) * p.hop
    return np.pad(audio, ((0, 0), (0, block * n_stream - audio.shape[1])))


def _numpy(res: SlotDecodeResult) -> SlotDecodeResult:
    return SlotDecodeResult(*(f.cpu().numpy() for f in res))


def _preroll_rows(audio: np.ndarray, p: WaterfallParams, max_candidates,
                  min_score, max_iterations, use_mf, use_osd, mf_first,
                  mf_refine, device) -> SlotDecodeResult | None:
    """The pre-roll decode over the leading slice, as numpy, or None when
    the capture is shorter than a frame (``streaming.py:291-298``)."""
    pre_w = min(audio.shape[1], (C.NUM_SYMBOLS + 1) * p.nperseg)
    if pre_w < p.nperseg:
        return None
    res = _decode_preroll(audio[:, :pre_w], p, max_candidates,
                          float(min_score), max_iterations, use_mf, use_osd,
                          mf_first, mf_refine, device)
    return _numpy(res)


def decode_stream(audio, sample_rate: float, mesh=None,
                  bins_per_tone: int = 2, steps_per_symbol: int = 2,
                  max_candidates: int = 20, min_score: float = 10.0,
                  max_iterations: int = 20,
                  use_mf: bool = False,
                  use_osd: bool = False,
                  mf_first: bool = False,
                  mf_refine: bool = False,
                  device: str | torch.device = "cuda"
                  ) -> list[FT8Decode] | None:
    """Host API: decode a long (or multi-channel) capture over the mesh
    (``streaming.py:237``).

    audio: (n,) or (channels, n) float samples, the same on every rank.
    The stream is padded to a whole number of equal blocks per stream
    coordinate.  ``mesh`` None is a (1 channel, world size stream) mesh of
    every rank when a torch.distributed group is initialised, else this
    process alone (no collective).  Every rank of the mesh returns the same
    rows; a rank outside it returns None.  The capture-start pre-roll runs
    on every rank of the mesh (one small decode a channel).
    """
    device = entry_device(device)
    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    if mesh is None and dist.is_initialized():
        mesh = make_mesh(stream=dist.get_world_size(), channel=1,
                         device=device)
    audio = _pad_capture(audio, axis(mesh, "channel")[2],
                         axis(mesh, "stream")[2], p)
    out = decode_stream_sharded(audio, p, mesh, max_candidates,
                                float(min_score), max_iterations, use_mf,
                                use_osd, mf_first, mf_refine, device)
    if out is None:
        return None
    res, n_success = out
    pre_res = _preroll_rows(audio, p, max_candidates, min_score,
                            max_iterations, use_mf, use_osd, mf_first,
                            mf_refine, device)
    block = audio.shape[1] // axis(mesh, "stream")[2]
    return _format_stream_results(_numpy(res), pre_res, int(n_success), p,
                                  block // p.hop)


def _format_stream_results(res, pre_res, n_success: int, p: WaterfallParams,
                           block_frames: int) -> list[FT8Decode]:
    """Stacked results as numpy (+ the optional pre-roll) -> deduped
    FT8Decode rows (``streaming.py:302``, a copy).

    Shared by decode_stream and the composed-mesh decoder
    (``composed.py``) so their host-side semantics cannot drift."""
    if n_success == 0 and (pre_res is None or not pre_res.success.any()):
        return []

    hop_seconds = C.SYMBOL_PERIOD_S / p.time_osr
    freq_step = C.TONE_SPACING_HZ / p.freq_osr
    out: list[FT8Decode] = []
    seen: set[tuple[int, bytes, int]] = set()
    channels, blocks, k = res.success.shape
    if pre_res is not None:
        for c in range(pre_res.success.shape[0]):
            for i in range(pre_res.success.shape[1]):
                if not pre_res.success[c, i]:
                    continue
                t_abs = int(pre_res.abs_time[c, i])        # negative
                key = (c, bytes(pre_res.payload[c, i].tolist()),
                       int(round(t_abs * hop_seconds / C.SLOT_PERIOD_S)))
                if key in seen:
                    continue
                seen.add(key)
                h = int(pre_res.crc[c, i])
                out.append(FT8Decode(
                    message=FT8Message(
                        payload=bytes(pre_res.payload[c, i].tolist()),
                        hash=h),
                    status=FT8DecodeStatus(
                        ldpc_errors=int(pre_res.ldpc_errors[c, i]),
                        crc_extracted=int(pre_res.crc_extracted[c, i]),
                        crc_calculated=h),
                    time_sec=t_abs * hop_seconds,
                    freq_hz=float(pre_res.abs_freq[c, i]) * freq_step,
                    score=float(pre_res.score[c, i]),
                ))
    for c in range(channels):
        for b in range(blocks):
            for i in range(k):
                if not res.success[c, b, i]:
                    continue
                t_abs = int(res.abs_time[c, b, i]) + b * block_frames
                h = int(res.crc[c, b, i])
                # dedup key: payload within +-1 frame period per channel
                # (payload, not the 14-bit CRC — CRC collisions must not
                # drop a genuinely distinct message)
                key = (c, bytes(res.payload[c, b, i].tolist()),
                       int(round(t_abs * hop_seconds / C.SLOT_PERIOD_S)))
                if key in seen:
                    continue
                seen.add(key)
                out.append(FT8Decode(
                    message=FT8Message(
                        payload=bytes(res.payload[c, b, i].tolist()), hash=h),
                    status=FT8DecodeStatus(
                        ldpc_errors=int(res.ldpc_errors[c, b, i]),
                        crc_extracted=int(res.crc_extracted[c, b, i]),
                        crc_calculated=h),
                    time_sec=t_abs * hop_seconds,
                    freq_hz=float(res.abs_freq[c, b, i]) * freq_step,
                    score=float(res.score[c, b, i]),
                ))
    out.sort(key=lambda r: (r.time_sec, r.freq_hz))
    return out
