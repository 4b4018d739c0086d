"""Entry ``qso``: the program's host API, ``decode_ft8_message``, with the
configuration's deep retries (``mf_refine``, ``coherent``, ``ap``), on a
station's captures in a QSO (``qso.py``).

Set-up makes the traffic's pool of captures on the device and hands each
to the host as a numpy array, as a station's sound card would; a call is
one capture through the host API on the card, numpy in, rows out.  Every
call's rows are kept; once the window closes, a sample of calls drawn from
the seed (distinct captures) is decoded again by the plain reference
(``reference/retries.py``) and compared (``compare.compare_rows``).  The
check also prints, to standard error, the candidates and rows each retry
of the reference won in the sample and the rows of the whole window whose
payload was never planted (false decodes).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import bounds, compare, qso
from ..reference import decode as ref_decode
from ..reference import front, retries

__all__ = ["Entry", "unplanted"]


def unplanted(rows_by_call: list[list], plans: list) -> list[int]:
    """Per call (call i decodes capture i mod P), its rows whose payload
    no transmission of the capture carries."""
    planted = [{bytes(p) for p in plan.payload} for plan in plans]
    return [sum(bytes(r.message.payload) not in planted[i % len(plans)]
                for r in rows) for i, rows in enumerate(rows_by_call)]


class Entry:
    """One cell's deepest ``decode_ft8_message`` traffic, calls and
    check."""

    reference_precision_key = "decode_ft8_message"
    units_per_call = 1

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from ft8_demodulator_tpu_torch.demod import decode as prog

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.fs = float(traffic["fs"])
        waves, self.plans = qso.make_captures(traffic, seed, device)
        self.pool = list(waves.cpu().numpy())
        self.kwargs = dict(
            bins_per_tone=cfg["bins_per_tone"],
            steps_per_symbol=cfg["steps_per_symbol"],
            max_candidates=cfg["max_candidates"],
            min_score=float(cfg["min_score"]),
            max_iterations=cfg["max_iterations"], use_osd=cfg["use_osd"],
            use_mf=cfg["use_mf"], device=device,
            **cfg["decode_ft8_message"])
        self.decode = prog.decode_ft8_message
        self.rows: list = []

    def warm(self) -> None:
        """Two captures (the first builds and caches the geometry's and the
        hypotheses' constants), not kept."""
        for x in self.pool[:2]:
            self.decode(x, self.fs, **self.kwargs)

    def call(self, i: int) -> int:
        self.rows.append(self.decode(self.pool[i % len(self.pool)], self.fs,
                                     **self.kwargs))
        return 1

    def kernel_bounds(self) -> dict[str, bounds.Bound]:
        rp = front.geometry(self.fs, self.cfg["bins_per_tone"],
                            self.cfg["steps_per_symbol"])
        nf = rp.num_frames(len(self.pool[0]))
        g = front.search_grid(rp.num_freq_bins, nf, rp.time_osr,
                              rp.freq_osr)
        return {"k6": bounds.sync(g, 1, nf, rp.num_freq_bins)}

    def sample(self, seed: int) -> list[int]:
        """Calls of the window, one per capture, drawn from the seed."""
        rng = np.random.default_rng([seed, 1])
        first = {}
        for c in rng.permutation(len(self.rows)):
            first.setdefault(int(c) % len(self.pool), int(c))
        return list(first.values())[: int(self.traffic["sample"])]

    def free(self) -> None:
        self.rows = []
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_decodes(self, calls, precision: str, dtype=torch.float32,
                          ap: bool = True) -> list[retries.Deepest]:
        """The plain reference's decode of each call's capture."""
        with ref_decode.exact_float32():
            return [retries.decode_capture(
                self.pool[c % len(self.pool)], self.fs, self.cfg, self.device,
                precision, dtype, ap=ap) for c in calls]

    def reference_rows(self, calls, precision: str, dtype=torch.float32,
                       ap: bool = True) -> list:
        return [d.rows for d in self.reference_decodes(calls, precision,
                                                       dtype, ap)]

    def report(self, calls, decodes: list[retries.Deepest]) -> None:
        """What the reference's retries won in the sample, and the
        window's false decodes, to standard error."""
        won: dict[str, int] = {}
        rows: dict[str, int] = {}
        for d in decodes:
            for k, v in d.accepted.items():
                won[k] = won.get(k, 0) + v
            for s in d.stages:
                rows[s] = rows.get(s, 0) + 1
        false = unplanted(self.rows, self.plans)
        print(f"sample of {len(calls)} captures: candidates won {won}, rows "
              f"by stage {rows}", file=sys.stderr)
        print(f"window: {len(false)} calls, {sum(false)} rows of payloads "
              f"never planted ({sum(x > 0 for x in false)} calls with one)",
              file=sys.stderr)

    def check(self, seed: int, limits: dict, precision: str) -> dict:
        calls = self.sample(seed)
        mine = [[ref_decode.Row(r.message.payload, r.time_sec, r.freq_hz,
                                r.score, r.snr_db) for r in self.rows[c]]
                for c in calls]
        theirs = self.reference_decodes(calls, precision)
        self.report(calls, theirs)
        self.free()
        return compare.compare_rows(mine, [d.rows for d in theirs])
