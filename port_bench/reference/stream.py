"""The plain reference of the program's continuous stream: what
``StreamSession`` with ``use_osd``, ``use_mf``, ``mf_refine`` and
``coherent`` delivers from one band's audio fed in any buffers, in plain
PyTorch.

The stream's rules:

* blocks: block b is the stream's samples [b L, b L + L + A), zero-padded
  at the end, with L the block (``block_seconds`` as a whole number of
  hops: 180,000 samples at 12 kHz) and A the lookahead, one whole
  transmission and a symbol more (80 symbols: 153,600 samples), so a
  transmission that starts in a block lies whole in it.  Every block has
  the geometry of L + A samples (692 frames at osr 4x4).  At the end of a
  stream (``flush``) the rest, if it holds one symbol's samples, is one
  last block of the same length, zero-padded;
* the search grid: start times [0, L / hop) of the block (375 frames), so
  each start time of the stream is searched in one block; the first block
  also searches the 10-symbol pre-roll before the stream's sample 0, and
  the last block of a flush every start time backed by real samples;
* the chain on each block (:func:`decode_block`): the float64 waterfall,
  the Costas sync, top-K, Hann LLRs, BP + OSD; the matched-filter retry
  with the refined search (its base LLRs, then its refined ones:
  ``retries.mf_refined``; without ``mf_refine`` the block spectra's
  matched filter, ``front.llrs_mf_blocks``); the coherent retry, the five
  coherent branches of the block's analytic signal
  (``retries.coherent_branches``, the stacked retry's mathematics at R 1)
  decoded as one batch, each candidate taking its first branch that
  decodes; each retry only on the candidates still undecoded; the SNR
  estimate over the frames backed by samples;
* delivery (:class:`Delivery`), the decoded candidates of each block in
  candidate order: a row under -26 dB is dropped (a CRC-lucky false
  accept); a row is a duplicate, and dropped, when its key (payload,
  round(t hop / 15 s)), t its absolute start in frames, was delivered
  before, or when the same payload was delivered less than the
  configuration's ``dedup_window_s`` (half a slot, 7.5 s) from it.

Departures from a published description: WSJT-X decodes each UTC-aligned
15-s slot on its own and needs no block edge, lookahead or cross-block
de-duplication; the upstream receiver (``pluto-sdr/receive.py``) hands
0.16-s buffers to a slot decoder, not to a stream.  The blocks, the
lookahead, the pre-roll and both de-duplication rules are the program's
own: the slot key is the JAX package's, and the half-slot rule is the
port's (the slot key alone delivers a transmission twice when its start
times round to two slots, which a stream that is not slot-aligned makes
happen).  The refined and coherent retries are the port's own beyond
WSJT-X's Deep.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from . import constants as C
from . import front, ldpc, retries
from .decode import Row, _snr_db

__all__ = ["MIN_SNR_DB", "Rules", "rules", "block_samples", "block_grid",
           "BlockDecode", "decode_block", "Delivery", "plan",
           "decode_stream"]

MIN_SNR_DB = -26.0
LOOKAHEAD_SYMBOLS = C.NUM_SYMBOLS + 1


class Rules(NamedTuple):
    """A stream's geometry."""

    p: front.Geometry
    block_len: int             # L, samples
    lookahead: int             # A, samples
    num_frames: int            # frames of every block (L + A samples)


def rules(fs: float, cfg: dict, block_seconds: float | None = None) -> Rules:
    """The geometry of ``cfg``'s stream at ``fs`` (``block_seconds``: the
    configuration's ``stream`` ``block_seconds`` where None)."""
    p = front.geometry(fs, cfg["bins_per_tone"], cfg["steps_per_symbol"])
    if block_seconds is None:
        block_seconds = cfg["stream"]["block_seconds"]
    hops = max(1, int(round(block_seconds * fs / p.hop)))
    big_l, big_a = hops * p.hop, LOOKAHEAD_SYMBOLS * p.nperseg
    return Rules(p, big_l, big_a, p.num_frames(big_l + big_a))


def block_samples(samples: Callable[[int, int], np.ndarray], r: Rules,
                  b: int, take: int | None = None,
                  lookahead: bool = True) -> np.ndarray:
    """Block ``b`` of the stream (``samples(lo, hi)``: the stream's
    samples [lo, hi)) as L + A float32 samples: its ``take`` samples (L + A
    where None), zeros after.  ``lookahead`` False (a control) keeps only
    the block's own L samples."""
    length = r.block_len + r.lookahead
    take = length if take is None else take
    if not lookahead:
        take = min(take, r.block_len)
    x = np.zeros(length, np.float32)
    x[:take] = samples(b * r.block_len, b * r.block_len + take)
    return x


def block_grid(r: Rules, first: bool, stop: int | None = None
               ) -> front.SearchGrid:
    """The search grid of a block: start frames [0, L / hop) (``stop``
    where given), from the pre-roll's on the first block."""
    p = r.p
    t_start = -front.PRE_ROLL_SYMBOLS * p.time_osr if first else 0
    t_stop = r.block_len // p.hop if stop is None else stop
    return front.SearchGrid(p.time_osr, p.freq_osr, r.num_frames // p.time_osr,
                            t_start, t_stop - t_start,
                            max(0, p.num_freq_bins - 7 * p.freq_osr))


class BlockDecode(NamedTuple):
    """A block's K candidates, host numpy, in candidate order; per
    candidate the stage that first decoded it ("first", "mf" or
    "mf_base" and "mf_refined", "coherent", or "")."""

    abs_time: np.ndarray       # frames of the block
    abs_freq: np.ndarray
    score: np.ndarray          # float32
    success: np.ndarray
    payload: np.ndarray        # (K, 10) uint8
    snr_db: np.ndarray         # float32
    stage: np.ndarray


def decode_block(x: np.ndarray, r: Rules, cfg: dict, device, first: bool,
                 precision: str = "float64", dtype=torch.float32,
                 take: int | None = None, final: bool = False,
                 tb: ldpc.Tables | None = None) -> BlockDecode:
    """One block's L + A samples -> its candidates.  ``precision``: the
    DFT's; ``dtype``: everything's from the power on; ``take``: the
    samples of the stream in it (the rest is padding); ``final``: the last
    block of a flush, which searches every start time backed by samples."""
    p = r.p
    take = len(x) if take is None else take
    valid_frames = p.num_frames(take)
    g = block_grid(r, first, valid_frames if final else None)
    tb = tb or ldpc.tables(device)
    wave = torch.as_tensor(np.asarray(x, np.float32), device=device)
    spec = front.block_spectra(wave, p, r.num_frames, precision)
    mag = front.db_grid_tf(spec, p, r.num_frames, dtype)
    t, f, s, valid = front.find_candidates_tf(
        front.sync_scores_tf(mag, g), g, cfg["max_candidates"],
        float(cfg["min_score"]))
    finish = lambda llrs: ldpc.finish_decode(
        llrs, valid, cfg["max_iterations"], cfg["use_osd"], tb)
    dec = finish(front.llrs_hann_tf(mag, t, f, g))
    stage = np.where(dec.success.cpu().numpy(), "first", "").astype(object)

    def step(retry, name):
        nonlocal dec
        dec, took = retries.merge(dec, retry)
        stage[took.cpu().numpy()] = name

    if cfg["use_mf"] and cfg["mf_refine"]:
        base, refined, _ = retries.mf_refined(wave, t, f, p, dtype)
        step(finish(base), "mf_base")
        step(finish(refined), "mf_refined")
    elif cfg["use_mf"]:
        step(finish(front.llrs_mf_blocks(spec, t, f, g, dtype)), "mf")
    if cfg["coherent"]:
        step(retries.variant_decode(retries.coherent_branches(
            wave, t, f, p, dtype), valid, cfg, tb)[0], "coherent")
    snr = _snr_db(mag[:valid_frames], dec.payload, t, f, g)
    host = lambda a: a.cpu().numpy()
    return BlockDecode(host(t), host(f), host(s.float()), host(dec.success),
                       host(dec.payload), host(snr.float()), stage)


class Delivery:
    """The session's delivery across blocks: the -26 dB gate and both
    de-duplication rules (``window_s``: the configuration's
    ``dedup_window_s``), with the counts the program keeps."""

    def __init__(self, r: Rules, window_s: float = C.SLOT_PERIOD_S / 2):
        self.hop_s = C.SYMBOL_PERIOD_S / r.p.time_osr
        self.step_hz = C.TONE_SPACING_HZ / r.p.freq_osr
        self.near = window_s / self.hop_s
        self.seen: set[tuple[bytes, int]] = set()
        self.delivered_at: dict[bytes, int] = {}
        self.counts = {"blocks": 0, "rows": 0, "weak": 0, "duplicates": 0}

    def deliver(self, d: BlockDecode, frame_offset: int) -> tuple[list, list]:
        """A block's decode -> (its rows, the stage of each)."""
        self.counts["blocks"] += 1
        rows, stages = [], []
        for k in np.flatnonzero(d.success):
            self.counts["rows"] += 1
            snr = float(d.snr_db[k])
            if snr < MIN_SNR_DB:
                self.counts["weak"] += 1
                continue
            t_abs = int(d.abs_time[k]) + frame_offset
            pl = bytes(d.payload[k].tolist())
            key = (pl, int(round(t_abs * self.hop_s / C.SLOT_PERIOD_S)))
            last = self.delivered_at.get(pl)
            if key in self.seen or (last is not None
                                    and abs(t_abs - last) < self.near):
                self.counts["duplicates"] += 1
                continue
            self.seen.add(key)
            self.delivered_at[pl] = t_abs
            rows.append(Row(pl, t_abs * self.hop_s,
                            float(d.abs_freq[k]) * self.step_hz,
                            float(d.score[k]),
                            round(min(max(snr, -30.0), 30.0), 1)))
            stages.append(str(d.stage[k]))
        return rows, stages


def plan(total: int, r: Rules, flush: bool) -> list[tuple[int, int, bool]]:
    """The blocks a stream of ``total`` samples completes: (b, samples of
    the stream in it, final), with the last block of a ``flush``."""
    length = r.block_len + r.lookahead
    full = (total - length) // r.block_len + 1 if total >= length else 0
    out = [(b, length, False) for b in range(full)]
    rest = total - full * r.block_len
    if flush and rest >= r.p.nperseg:
        out.append((full, rest, True))
    return out


def decode_stream(samples: Callable[[int, int], np.ndarray], total: int,
                  fs: float, cfg: dict, device, flush: bool = True,
                  precision: str = "float64", dtype=torch.float32,
                  lookahead: bool = True,
                  block_seconds: float | None = None
                  ) -> tuple[list[list], Delivery]:
    """The rows of each block of a stream of ``total`` samples
    (``samples(lo, hi)``), and the delivery's state and counts."""
    r = rules(fs, cfg, block_seconds)
    tb = ldpc.tables(device)
    out = Delivery(r, cfg["stream"]["dedup_window_s"])
    rows = []
    for b, take, final in plan(total, r, flush):
        x = block_samples(samples, r, b, take, lookahead)
        # without the lookahead, only the block's own samples are real
        real = take if lookahead else min(take, r.block_len)
        d = decode_block(x, r, cfg, device, b == 0, precision, dtype, real,
                         final, tb)
        rows.append(out.deliver(d, b * r.block_len // r.p.hop)[0])
    return rows, out
