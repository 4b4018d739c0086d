"""Entry ``beacon``: the program's beacon receiver, ``BeaconSession.feed``,
as the CLI's ``--stack`` drives it.

Set-up makes the traffic's pool of passes (``passes.py``) on the device and
hands them to the host as float32, as a sound card would.  Call i runs
cycle i mod C of pass (i div C) mod P (C cycles a pass, P passes): one 15-s
cycle fed as ``cycle / feed_samples`` feeds, the last of which completes
the cycle, so that the session drift-corrects it, pushes it into its ring
and decodes the stack of the ring.  A call is timed from its first feed to
the rows in hand.  Each pass starts a new session, with an empty ring.

The check, after the window: a pass drawn from the seed among those the
window ran whole (its latest run; else the run in progress, as far as it
went) is run again by the plain reference as a session
(``reference/stack.py``), each cycle with the corrector model the timed
call's session kept as the hint for sync-frame ties, and compared
(:func:`compare_pass`).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .. import compare, passes
from ..reference import constants as C
from ..reference import decode as ref_decode
from ..reference import stack as ref_stack

__all__ = ["DTYPES", "Entry", "model_s", "hint", "compare_pass"]

# the reference's precision from the configuration's word, and one step down
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


def model_s(model, steps_per_symbol: int) -> tuple:
    """A reference corrector model's segment and sync frame in seconds, as
    the program's ``return_model`` gives them (None where it stopped
    earlier)."""
    t_step = C.SYMBOL_PERIOD_S / steps_per_symbol
    seg = None if model.segment is None else (model.segment[0] * t_step,
                                              model.segment[1] * t_step)
    sync = None if model.sync_frame is None else model.sync_frame * t_step
    return seg, sync


def hint(model_seconds: tuple, steps_per_symbol: int) -> tuple:
    """A program's (segment, sync frame) in seconds -> in frames, the
    reference corrector's hint."""
    t_step = C.SYMBOL_PERIOD_S / steps_per_symbol
    seg, sync = model_seconds
    frames = lambda v: int(round(v / t_step))
    return (None if seg is None else (frames(seg[0]), frames(seg[1])),
            None if sync is None else frames(sync))


def compare_pass(prog: list[list], ref: list[list], prog_ring: np.ndarray,
                 prog_models: list, ref_session: ref_stack.Session
                 ) -> dict[str, float]:
    """One pass: ``prog`` / ``ref`` the rows each side first reported at
    each cycle (:class:`reference.decode.Row`, times from the session's
    start); ``prog_ring`` the side's corrected cycles still in its ring at
    the end (oldest first); ``prog_models`` the segment and sync frame its
    corrector found in each cycle of the pass (seconds, None without one);
    ``ref_session`` the reference's session after the same cycles, each
    given the side's model as its hint.

    * ``score_gap``, ``row_diff_pct``: ``compare.compare_rows`` over the
      pass's rows (a twin: the same payload at the same time, so at the
      same cycle, and frequency, its SNR within 0.1 dB);
    * ``first_cycle_gap``: the largest difference between the two sides'
      first-report cycles of a payload (the cycles compared, where only
      one side reports it);
    * ``models_differ``: cycles whose corrector found another segment, or
      a sync frame that is no tie of the reference's;
    * ``sync_ties``: cycles whose sync frame is another near-maximum of
      the reference's template correlation than its first, which the
      reference then took: where the corrector fits noise, the masked,
      bin-quantised track makes such ties, and a pulse that differs in the
      last place breaks them;
    * ``ring_gap``: on the ring cycles of equal models, the largest
      |program - reference| sample over the reference's rms.
    """
    out = compare.compare_rows([sum(prog, [])], [sum(ref, [])])
    first = lambda side: {r.payload: c for c in reversed(range(len(side)))
                          for r in side[c]}
    a, b = first(prog), first(ref)
    out["first_cycle_gap"] = float(max(
        [abs(a[k] - b[k]) if k in a and k in b else len(prog)
         for k in set(a) | set(b)], default=0))
    steps = ref_session.cfg["steps_per_symbol"]
    same = [model_s(m, steps) == pm
            for m, pm in zip(ref_session.models, prog_models)]
    out["models_differ"] = float(same.count(False))
    out["sync_ties"] = float(sum(m.tied for m, ok in
                                 zip(ref_session.models, same) if ok))
    n = len(prog_ring)
    gap = 0.0
    for mine, z, ok in zip(prog_ring, ref_session.cycles[-n:] if n else [],
                           same[-n:] if n else []):
        if not ok:
            continue
        z = z.cpu().numpy().astype(np.complex128)
        rms = float(np.sqrt(np.mean(np.abs(z) ** 2)))
        gap = max(gap, float(np.max(np.abs(mine - z))) / max(rms, 1e-30))
    out["ring_gap"] = gap
    return out


class Entry:
    """One cell's beacon traffic, calls and check."""

    reference_precision_key = "beacon"
    units_per_call = 1

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from ft8_demodulator_tpu_torch.demod import BeaconSession

        self.cfg, self.device = cfg, device
        self.fs = float(traffic["fs"])
        self.pool = passes.make_passes(traffic, seed, device)
        self.cycles = int(traffic["cycles_per_pass"])
        self.feed = int(traffic["feed_samples"])
        keys = ("max_repeats", "use_osd", "coherent", "ap", "min_z",
                "max_candidates", "correction", "bins_per_tone",
                "steps_per_symbol", "min_score", "max_iterations",
                "refine_fixes")
        self.new_session = lambda: BeaconSession(
            self.fs, device=device, **{k: cfg[k] for k in keys})
        self.session = None
        self.rows: dict[int, list] = {}   # call -> the rows it reported
        self.models: dict[int, tuple] = {}  # call -> its cycle's drift model
        self.runs: dict = {}              # pass -> (first call, session)

    def _cycle(self, session, audio: np.ndarray) -> list:
        out = []
        for a in range(0, len(audio), self.feed):
            out.extend(session.feed(audio[a: a + self.feed]))
        return out

    def warm(self) -> None:
        """Two cycles (the pass's first and middle) in a session of their
        own: the first builds and caches the geometry's constants and
        kernels."""
        s = self.new_session()
        for c in (0, self.cycles // 2):
            self._cycle(s, self.pool[0].audio[c])

    def call(self, i: int) -> int:
        p, c = (i // self.cycles) % len(self.pool), i % self.cycles
        if c == 0 or self.session is None:
            self.session = self.new_session()
        rows = self._cycle(self.session, self.pool[p].audio[c])
        self.rows[i] = [ref_decode.Row(r.message.payload, r.time_sec,
                                       r.freq_hz, r.score, r.snr_db)
                        for r in rows]
        kept = getattr(self.session, "drift_models", None)
        if kept:
            self.models[i] = (kept[-1]["segment_s"], kept[-1]["sync_time_s"])
        if c == self.cycles - 1:
            self.runs[p] = (i - c, self.session)
        return 1

    def kernel_bounds(self) -> dict:
        return {}

    def sample(self, seed: int) -> tuple[int, int, int, object]:
        """(pass, first call, cycles, session at its end) of the pass the
        check compares."""
        if self.runs:
            rng = np.random.default_rng([seed, 1])
            p = sorted(self.runs)[int(rng.integers(len(self.runs)))]
            first, session = self.runs[p]
            return p, first, self.cycles, session
        last = max(self.rows)
        p = (last // self.cycles) % len(self.pool)
        return p, last - last % self.cycles, last % self.cycles + 1, \
            self.session

    def program_ring(self, session) -> np.ndarray:
        """The corrected cycles in the session's checkpoint (its public
        ``save``), oldest first."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "session.npz")
            session.save(path)
            with np.load(path) as z:
                return np.asarray(z["cycles"])

    def program_models(self, p: int, first: int, cycles: int) -> list:
        """The segment and sync frame (seconds) the timed calls' corrector
        found in each cycle of the pass, as the session kept them
        (``drift_models``); a program that does not keep them has its
        corrector run again on the same cycles."""
        calls = range(first, first + cycles)
        if all(i in self.models for i in calls):
            return [self.models[i] for i in calls]
        import scipy.signal

        from ft8_demodulator_tpu_torch.beacon import correct_frequency_drift

        out = []
        for c in range(cycles):
            *_, m = correct_frequency_drift(
                scipy.signal.hilbert(self.pool[p].audio[c].astype(np.float64)),
                self.fs, params={
                    "bins_per_tone": self.cfg["bins_per_tone"],
                    "steps_per_symbol": self.cfg["steps_per_symbol"]},
                return_model=True, device=self.device)
            out.append((m["segment_s"], m["sync_time_s"]))
        return out

    def reference_session(self, p: int, cycles: int, precision: str,
                          models: list | None = None):
        """The reference's session over the pass's first ``cycles``
        cycles, each with another side's model (seconds) as its hint:
        (rows first reported at each cycle, the session)."""
        ref = ref_stack.Session(self.fs, self.cfg, self.device,
                                DTYPES[precision])
        steps = self.cfg["steps_per_symbol"]
        hints = [None if models is None else hint(models[c], steps)
                 for c in range(cycles)]
        with ref_decode.exact_float32():
            rows = [ref.cycle(self.pool[p].audio[c], hints[c])
                    for c in range(cycles)]
        return rows, ref

    def check(self, seed: int, limits: dict, precision: str) -> dict:
        p, first, cycles, session = self.sample(seed)
        mine = [self.rows.get(i, []) for i in range(first, first + cycles)]
        ring = self.program_ring(session)
        models = self.program_models(p, first, cycles)
        self.rows, self.models, self.runs, self.session = {}, {}, {}, None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        rows, ref = self.reference_session(p, cycles, precision, models)
        return compare_pass(mine, rows, ring, models, ref)
