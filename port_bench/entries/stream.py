"""Entry ``stream``: the program's continuous stream, ``StreamSession``,
with the configuration's settings, fed an SDR skimmer's band
(``streams.py``).

Set-up first makes one session with the configuration's settings, so that
a program which lacks one of them (the dedup window that holds the
exactly-once guarantee) fails at once; then it makes the traffic's pool of
slots on the device and hands it to the host, and warms a session of its own over the first ``warm_calls`` calls
(the pre-roll block's shapes and the steady block's).  The window's
session starts at the stream's sample 0 and lives for the whole window: a
call feeds the next 15 s of the stream as the receiver's buffers and
returns with the rows of its last feed in hand.  Every call keeps its
rows and the index of the block each came from.

The check compares two samples of blocks with the plain reference
(``reference/stream.py``), each decoded from a fresh delivery state:
blocks 0-1 (the pre-roll and the first steady block), and
``sample_blocks`` consecutive blocks drawn from the seed among those the
window completed, after the block before them, which the reference decodes
uncompared so that its de-duplication state matches the session's.  The
numbers: ``score_gap`` and ``row_diff_pct`` (``compare.compare_rows``, one
list of rows a block), and ``dup_rows``, the window's rows delivered twice
for one transmission (the same payload less than 15 s after an earlier
row).  It also prints, to standard error, the rows each stage of the
reference delivered in the samples, and the window's rows whose payload
was never planted.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import bounds, compare, streams
from ..reference import constants as C
from ..reference import decode as ref_decode
from ..reference import stream as ref_stream

__all__ = ["Entry", "dup_rows"]


def dup_rows(rows: list) -> int:
    """Rows (``reference.decode.Row``) whose payload an earlier row carried
    less than one slot before: one transmission delivered twice."""
    times: dict[bytes, list[float]] = {}
    for r in rows:
        times.setdefault(r.payload, []).append(r.time_s)
    return sum(int(np.sum(np.diff(np.sort(t)) < C.SLOT_PERIOD_S))
               for t in times.values())


class Entry:
    """One cell's stream traffic, calls and check."""

    reference_precision_key = "stream"
    units_per_call = 1

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from ft8_demodulator_tpu_torch.config import DecoderConfig
        from ft8_demodulator_tpu_torch.demod.stream_session import \
            StreamSession

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.config = DecoderConfig(
            bins_per_tone=cfg["bins_per_tone"],
            steps_per_symbol=cfg["steps_per_symbol"],
            max_candidates=cfg["max_candidates"],
            min_score=float(cfg["min_score"]),
            max_iterations=cfg["max_iterations"], use_osd=cfg["use_osd"],
            use_mf=cfg["use_mf"], mf_first=cfg["mf_first"],
            mf_refine=cfg["mf_refine"], coherent=cfg["coherent"])
        self.session_type = StreamSession
        self.fs = float(traffic["fs"])
        # a program without one of the configuration's stream settings (the
        # dedup window that holds its exactly-once guarantee) refuses it
        # here, before any traffic is made
        self.new_session()
        self.stream = streams.make_stream(traffic, seed, device)
        self.rules = ref_stream.rules(self.stream.fs, cfg)
        self.session = None
        self.fed = 0               # samples the window's session was fed
        self.rows: list[list] = []  # per call: (block, its rows) a feed

    def new_session(self):
        st = self.cfg["stream"]
        return self.session_type(
            self.fs, self.config, block_seconds=st["block_seconds"],
            pipeline_depth=st["pipeline_depth"], device=self.device,
            dedup_window_s=st["dedup_window_s"])

    def warm(self) -> None:
        """A session of its own over the first calls, not kept; then the
        window's session."""
        warm = self.new_session()
        for i in range(int(self.traffic["warm_calls"])):
            for buf in self.stream.call(i):
                warm.feed(buf)
        self.session = self.new_session()

    def blocks_done(self) -> int:
        """Blocks the window's session has completed."""
        return len(ref_stream.plan(self.fed, self.rules, False))

    def call(self, i: int) -> int:
        """Call ``i``: the stream's 15 s after what calls 0..i-1 fed."""
        out = []
        for buf in self.stream.call(i):
            rows = self.session.feed(buf)
            self.fed += len(buf)
            if rows:
                out.append((self.blocks_done() - 1, rows))
        self.rows.append(out)
        return 1

    def kernel_bounds(self) -> dict[str, bounds.Bound]:
        r = self.rules
        g = ref_stream.block_grid(r, first=False)
        return {"k6": bounds.sync(g, 1, r.num_frames, r.p.num_freq_bins)}

    def sample(self, seed: int, blocks: int | None = None) -> list[list[int]]:
        """Runs of consecutive blocks to compare, the first block of a run
        decoded uncompared where it is not block 0: [0, 1], then
        ``sample_blocks`` drawn from the seed after the block before them
        (``blocks``: the blocks completed, the window's where None)."""
        n = self.blocks_done() if blocks is None else blocks
        m = int(self.traffic["sample_blocks"])
        runs = [list(range(min(n, 2)))]
        if n > 2:
            rng = np.random.default_rng([seed, 1])
            first = int(rng.integers(2, max(2, n - m) + 1))
            runs.append(list(range(first - 1, min(n, first + m))))
        return [r for r in runs if r]

    def window_rows(self) -> dict[int, list]:
        """The window's rows by block, as ``reference.decode.Row``."""
        out: dict[int, list] = {}
        for call in self.rows:
            for b, rows in call:
                out.setdefault(b, []).extend(
                    ref_decode.Row(r.message.payload, r.time_sec, r.freq_hz,
                                   r.score, r.snr_db) for r in rows)
        return out

    def free(self) -> None:
        self.session = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_runs(self, runs: list[list[int]], precision: str,
                       dtype=torch.float32, lookahead: bool = True
                       ) -> tuple[dict[int, list], dict[int, list]]:
        """The plain reference's rows and stages of each run's compared
        blocks, each run from a fresh delivery state."""
        r = self.rules
        rows, stages = {}, {}
        with ref_decode.exact_float32():
            for run in runs:
                delivery = ref_stream.Delivery(
                    r, self.cfg["stream"]["dedup_window_s"])
                for b in run:
                    x = ref_stream.block_samples(self.stream.samples, r, b,
                                                 lookahead=lookahead)
                    d = ref_stream.decode_block(
                        x, r, self.cfg, self.device, b == 0, precision, dtype,
                        None if lookahead else r.block_len)
                    got = delivery.deliver(d, b * r.block_len // r.p.hop)
                    if b == 0 or b != run[0]:
                        rows[b], stages[b] = got
        return rows, stages

    def compared(self, runs: list[list[int]]) -> list[int]:
        """The blocks of ``runs`` that are compared."""
        return [b for run in runs for b in run if b == 0 or b != run[0]]

    def report(self, runs, stages: dict[int, list], mine: dict[int, list]
               ) -> None:
        """What each stage of the reference delivered in the samples, and
        the window's unplanted rows, to standard error."""
        by_stage: dict[str, int] = {}
        for b in self.compared(runs):
            for s in stages[b]:
                by_stage[s] = by_stage.get(s, 0) + 1
        planted = {bytes(p.tolist())
                   for p in self.stream.planted.payload.reshape(-1, 10)}
        rows = [q for b in sorted(mine) for q in mine[b]]
        false = sum(q.payload not in planted for q in rows)
        print(f"samples {runs}: rows by stage {by_stage}", file=sys.stderr)
        print(f"window: {self.blocks_done()} blocks, {len(rows)} rows, "
              f"{false} of payloads never planted", file=sys.stderr)

    def check(self, seed: int, limits: dict, precision: str) -> dict:
        runs = self.sample(seed)
        mine = self.window_rows()
        self.free()
        theirs, stages = self.reference_runs(runs, precision)
        self.report(runs, stages, mine)
        blocks = self.compared(runs)
        out = compare.compare_rows([mine.get(b, []) for b in blocks],
                                   [theirs[b] for b in blocks])
        out["dup_rows"] = float(dup_rows(
            [q for b in sorted(mine) for q in mine[b]]))
        return out
