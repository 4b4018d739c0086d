"""Online streaming decode session with checkpoint/resume.

Port of ``ft8_demodulator_tpu/demod/stream_session.py``.  A StreamSession
consumes an unbounded audio stream in feeds of any size, decodes each
completed block (with a one-frame lookahead so transmissions straddling
block edges decode exactly once) on ``device``, deduplicates across
blocks, and can snapshot its full state to disk and resume later.

* One function per block (:func:`_decode_block_packed`): waterfall, sync
  (the frequency-major stencil kernel on the card), BP (+ OSD), CRC, the
  retries and the SNR estimate, returning one packed (K, 18) float32
  tensor on the device; the host copies it once per block.
* Every block has the same geometry; the BP, CRC and OSD tables and the
  LLR constants reach the device once, through the caches of ``ops/``.
* The SNR estimate runs on every block and is masked to -inf on the rows
  that did not decode (the JAX package skips it under a ``lax.cond`` when
  nothing decoded); those rows are never delivered, so the rows are the
  same.
* ``pipeline_depth > 0`` defers the copy of up to that many blocks'
  results to a later feed() (or flush()): the same rows in the same
  order, later.  The decode synchronises inside anyway (BP tests after
  every iteration whether all rows halted, and the OSD counts the rows it
  needs), so only the final copy is deferred.
* A row is a duplicate when its (payload, slot) key, the slot index of
  its start time rounded, was delivered before, as in the JAX package, or
  when the same payload was delivered less than ``dedup_window_s``
  (default half a slot, 7.5 s; 0 keeps the slot key alone) from it.  One transmission found at neighbouring start times, or by two blocks
  at their edge, lies a few hops from itself, and a message repeated by a
  station comes a T/R period (15 s) later at the earliest; the slot key
  alone delivers such a transmission twice when its start times round to
  two slots, as a stream that is not aligned to the UTC slots makes
  happen.  The delivery times and the window are not part of a
  checkpoint: a resumed session has the slot keys alone for the rows
  delivered before it, and the default window.
* Checkpoints keep the JAX package's npz keys and dtypes, so a checkpoint
  written by either package loads in the other.
* Spans (``utils/profiling.py``): ``ft8.buffer`` (each feed's append, and
  each block's slice, pad and upload), ``ft8.waterfall``, ``ft8.rows``
  (delivery) and ``ft8.rows.wait`` (the block result's read-back, one wait
  a block); host counters ``stream.blocks``, ``stream.rows`` (success rows
  read back), ``stream.weak`` (dropped under -26 dB) and
  ``stream.duplicates`` (dropped by dedup), counted on every block and
  delivery, 0 included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DecoderConfig, STANDARD
from ..ops.sync import PRE_ROLL_SYMBOLS, SearchGrid
from ..ops.waterfall import WaterfallParams, waterfall_real
from ..protocol import constants as C
from ..protocol.message import CallsignHashTable, unpack_message
from ..utils.device import entry_device
from ..utils.profiling import count, host_wait, span
from .decode import (coherent_retry, decode_waterfall, decode_waterfall_mf,
                     estimate_snr, mf_retry)
from .types import FT8Decode, FT8DecodeStatus, FT8Message

__all__ = ["StreamSession"]

# packed result column layout (K rows, float32 — every field is exactly
# representable: success 0/1, CRC-14 <= 16383, payload bytes <= 255)
_COL_SUCCESS, _COL_CRC, _COL_CRC_EXT, _COL_ERRS = 0, 1, 2, 3
_COL_TIME, _COL_FREQ, _COL_SCORE, _COL_SNR = 4, 5, 6, 7
_COL_PAYLOAD = 8                      # 10 payload byte columns
_PACKED_COLS = _COL_PAYLOAD + C.PAYLOAD_BYTES


def _decode_block_packed(chunk: torch.Tensor, p: WaterfallParams,
                         g: SearchGrid, cfg: DecoderConfig,
                         num_frames: int, valid_frames: int) -> torch.Tensor:
    """One streaming block: audio -> packed (K, 18) float32 results on the
    device of ``chunk``."""
    with span("ft8.waterfall"):
        mag = waterfall_real(chunk, p, num_frames)
    if cfg.mf_first:
        res = decode_waterfall_mf(mag, chunk, p, g, 0, 0,
                                  cfg.max_candidates, cfg.min_score,
                                  cfg.max_iterations, cfg.use_osd,
                                  mf_refine=cfg.mf_refine)
    else:
        res = decode_waterfall(mag, g, cfg.max_candidates, cfg.min_score,
                               cfg.max_iterations, cfg.use_osd)
        if cfg.use_mf:
            res = mf_retry(chunk, p, res, 0, 0, cfg.max_iterations,
                           cfg.use_osd, mf_refine=cfg.mf_refine)
    if cfg.coherent:
        res = coherent_retry(chunk, p, res, 0, 0, cfg.max_iterations,
                             cfg.use_osd)

    snr = estimate_snr(mag, res.payload, res.abs_time, res.abs_freq,
                       p.time_osr, p.freq_osr, valid_frames=valid_frames)
    snr = torch.where(res.success, snr, -torch.inf)
    cols = [res.success, res.crc, res.crc_extracted, res.ldpc_errors,
            res.abs_time, res.abs_freq, res.score, snr]
    head = torch.stack([c.to(torch.float32) for c in cols], dim=1)
    return torch.cat([head, res.payload.to(torch.float32)], dim=1)


class StreamSession:
    """Incremental decoder over a continuous sample stream."""

    def __init__(self, fs: float, config: DecoderConfig = STANDARD,
                 block_seconds: float = float(C.SLOT_PERIOD_S),
                 pipeline_depth: int = 0,
                 device: str | torch.device = "cuda",
                 dedup_window_s: float = C.SLOT_PERIOD_S / 2):
        self.device = entry_device(device)
        self.fs = float(fs)
        self.config = config
        self.p = config.waterfall(fs)
        # block is a whole number of hops; lookahead covers one full frame
        hops = max(1, int(round(block_seconds * fs / self.p.hop)))
        self.block_len = hops * self.p.hop
        self.lookahead = (C.NUM_SYMBOLS + 1) * self.p.nperseg
        self.pipeline_depth = int(pipeline_depth)
        # every block has this geometry
        self._num_frames = self.p.num_frames(self.block_len + self.lookahead)
        self._buffer = np.zeros(0, np.float32)
        self._offset_samples = 0      # absolute sample index of buffer[0]
        self._seen: set[tuple[bytes, int]] = set()
        # each delivered payload's latest start (absolute frames)
        self._delivered_at: dict[bytes, int] = {}
        self.dedup_window_s = float(dedup_window_s)
        # decoded-but-uncopied block results: (device tensor, frame_offset)
        self._pending: list[tuple[torch.Tensor, int]] = []
        # copied success rows not yet formatted/delivered:
        # (packed_row ndarray, frame_offset)
        self._undelivered: list[tuple[np.ndarray, int]] = []
        # session-owned callsign hash cache: <CALL> resolutions learnt on
        # this band stay with this session and survive save/load
        self.hash_table = CallsignHashTable()

    def unpack(self, payload) -> str:
        """Message text for a decoded payload, resolving hashed calls
        against (and teaching) this session's own hash table."""
        return unpack_message(payload, hash_table=self.hash_table)

    # -- streaming -----------------------------------------------------------

    def feed(self, samples: np.ndarray) -> list[FT8Decode]:
        """Append samples; decode any newly-completed blocks.

        With the default ``pipeline_depth=0`` every completed block's
        rows return from this call.  With depth > 0 up to that many
        block results stay uncopied on the device and their rows are
        returned by a later feed() or flush() — same rows, same order.
        """
        chunk = np.asarray(samples, np.float32)
        if chunk.size:
            with span("ft8.buffer"):
                self._buffer = np.concatenate([self._buffer, chunk])
        while len(self._buffer) >= self.block_len + self.lookahead:
            self._dispatch_block()
        if not (self._pending or self._undelivered):
            return []       # most feeds: no block, nothing to deliver
        self._fetch_pending(keep=self.pipeline_depth)
        return self._deliver()

    def flush(self) -> list[FT8Decode]:
        """Decode whatever remains (end of stream).

        The final partial block searches EVERY remaining start time — also
        the ones past the last full block boundary — so a transmission
        clipped at the end of the capture is still found.
        """
        while len(self._buffer) >= self.block_len + self.lookahead:
            self._dispatch_block()
        if len(self._buffer) >= self.p.nperseg:
            self._dispatch_block(final=True)
        self._fetch_pending(keep=0)
        return self._deliver()

    def _device_chunk(self, take: int) -> torch.Tensor:
        """The next block's samples (zero-padded to the fixed length) as
        one copy to the device."""
        length = self.block_len + self.lookahead
        chunk = self._buffer[:take]
        if take < length:
            chunk = np.pad(chunk, (0, length - take))
        return torch.as_tensor(chunk, device=self.device)

    def _dispatch_block(self, final: bool = False) -> None:
        """Decode the next block; its uncopied device result queues on
        self._pending."""
        take = min(len(self._buffer), self.block_len + self.lookahead)
        with span("ft8.buffer"):
            chunk_d = self._device_chunk(take)
        num_frames = self._num_frames
        block_frames = self.block_len // self.p.hop
        # the very first block scans the slot decoder's 10-symbol pre-roll
        # (a transmission clipped at capture start still decodes); a final
        # flush block scans every start time backed by real samples
        t_start = -PRE_ROLL_SYMBOLS * self.p.time_osr \
            if self._offset_samples == 0 else 0
        t_stop = self.p.num_frames(take) if final else block_frames
        g = SearchGrid(
            time_osr=self.p.time_osr, freq_osr=self.p.freq_osr,
            num_blocks=num_frames // self.p.time_osr,
            t_start=t_start, num_times=t_stop - t_start,
            num_freqs=max(0, self.p.num_freq_bins - 7 * self.p.freq_osr),
        )
        packed = _decode_block_packed(chunk_d, self.p, g, self.config,
                                      num_frames, self.p.num_frames(take))
        self._pending.append((packed, self._offset_samples // self.p.hop))
        count("stream.blocks")
        consumed = take if final else self.block_len
        with span("ft8.buffer"):
            self._buffer = self._buffer[consumed:]
        self._offset_samples += consumed

    def _fetch_pending(self, keep: int) -> None:
        """Copy pending block results (one copy each) down to ``keep``
        still pending; success rows queue for delivery."""
        while len(self._pending) > keep:
            packed_d, frame_offset = self._pending.pop(0)
            with host_wait("ft8.rows.wait"):
                packed = packed_d.cpu().numpy()
            rows = packed[packed[:, _COL_SUCCESS] > 0]
            count("stream.rows", len(rows))
            for row in rows:
                self._undelivered.append((row, frame_offset))

    @span("ft8.rows")
    def _deliver(self) -> list[FT8Decode]:
        """Format + dedup all copied-but-undelivered rows."""
        out: list[FT8Decode] = []
        hop_seconds = C.SYMBOL_PERIOD_S / self.p.time_osr
        freq_step = C.TONE_SPACING_HZ / self.p.freq_osr
        # frames within the window of a delivery: the same transmission
        near = self.dedup_window_s / hop_seconds
        weak = duplicates = 0
        for row, frame_offset in self._undelivered:
            snr = float(row[_COL_SNR])
            if snr < -26.0:
                weak += 1
                continue    # implausibly weak: CRC-lucky false accept
            t_abs = int(row[_COL_TIME]) + frame_offset
            payload = bytes(int(v) for v in
                            row[_COL_PAYLOAD: _COL_PAYLOAD
                                + C.PAYLOAD_BYTES])
            # payload-keyed dedup: CRC-14 collisions must not drop messages
            key = (payload,
                   int(round(t_abs * hop_seconds / C.SLOT_PERIOD_S)))
            last = self._delivered_at.get(payload)
            if key in self._seen or (last is not None
                                     and abs(t_abs - last) < near):
                duplicates += 1
                continue
            self._seen.add(key)
            self._delivered_at[payload] = t_abs
            h = int(row[_COL_CRC])
            out.append(FT8Decode(
                message=FT8Message(payload=payload, hash=h),
                status=FT8DecodeStatus(
                    ldpc_errors=int(row[_COL_ERRS]),
                    crc_extracted=int(row[_COL_CRC_EXT]),
                    crc_calculated=h),
                time_sec=t_abs * hop_seconds,
                freq_hz=float(row[_COL_FREQ]) * freq_step,
                score=float(row[_COL_SCORE]),
                # the same clamp as decode_ft8_message's _format_results
                # (+30 means ">= +30")
                snr_db=round(min(max(snr, -30.0), 30.0), 1),
            ))
        self._undelivered.clear()
        count("stream.weak", weak)
        count("stream.duplicates", duplicates)
        return out

    # -- checkpoint / resume ---------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the full session state to an .npz checkpoint (the JAX
        package's keys; the device is not part of the state).

        Pending (pipeline_depth > 0) block results are copied first and
        persisted as raw undelivered rows, so nothing is lost and nothing
        double-reports after resume.
        """
        self._fetch_pending(keep=0)
        undelivered = np.array(
            [np.concatenate([row, [off]]) for row, off in self._undelivered],
            np.float64).reshape(-1, _PACKED_COLS + 1)
        seen = np.array(
            [list(payload) + [slot] for payload, slot in sorted(self._seen)],
            dtype=np.int64).reshape(-1, C.PAYLOAD_BYTES + 1)
        np.savez(path, fs=self.fs, buffer=self._buffer,
                 offset=self._offset_samples, seen=seen,
                 config=np.array(list(self.config), dtype=np.float64),
                 block_seconds=self.block_len / self.fs,
                 hash_calls=np.asarray(self.hash_table.calls()),
                 undelivered=undelivered)

    @classmethod
    def load(cls, path: str,
             device: str | torch.device = "cuda") -> "StreamSession":
        """A session from a checkpoint of either package, on ``device``."""
        with np.load(path) as npz:
            data = {k: npz[k] for k in npz.files}
        cfgvals = data["config"]
        cfg = DecoderConfig(
            bins_per_tone=int(cfgvals[0]), steps_per_symbol=int(cfgvals[1]),
            max_candidates=int(cfgvals[2]), min_score=float(cfgvals[3]),
            max_iterations=int(cfgvals[4]),
            use_osd=bool(cfgvals[5]) if len(cfgvals) > 5 else False,
            use_mf=bool(cfgvals[6]) if len(cfgvals) > 6 else False,
            mf_first=bool(cfgvals[7]) if len(cfgvals) > 7 else False,
            mf_refine=bool(cfgvals[8]) if len(cfgvals) > 8 else False,
            coherent=bool(cfgvals[9]) if len(cfgvals) > 9 else False)
        sess = cls(float(data["fs"]), cfg,
                   block_seconds=float(data["block_seconds"]), device=device)
        sess._buffer = data["buffer"].astype(np.float32)
        sess._offset_samples = int(data["offset"])
        sess._seen = {(bytes(int(v) for v in row[:-1]), int(row[-1]))
                      for row in data["seen"]}
        if "undelivered" in data:     # older checkpoints lack the queue
            sess._undelivered = [
                (row[:-1].astype(np.float32), int(row[-1]))
                for row in data["undelivered"]]
        if "hash_calls" in data:      # older checkpoints lack the table
            sess.hash_table = CallsignHashTable(
                str(c) for c in data["hash_calls"])
        return sess
