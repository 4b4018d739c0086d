"""The comparison that decides ``correct``: what the timed path produced
against the plain reference decoder (``reference/``) on the same inputs.

Slot decodes (``decode_slots``), per sampled slot:

* ``score_gap``: the largest |program score - reference score| over the
  program's valid candidates, the reference's score read from its own
  whole score grid at the program's (time, freq): the waterfall and the
  sync stencil;
* ``topk_missed``: candidates the program's top-K got wrong: a reference
  top-K cell the program lacks that beats the reference's K-th score by
  more than ``tie``, or a program cell the reference ranks below its K-th
  (or below ``min_score``, where fewer than K cells reach it) by more than
  ``tie`` (``tie``: twice the score limit; nearer the K-th
  score two scores that each sit within the limit may swap places);
* ``decode_diff_pct``: of the payloads either side decodes in a slot, the
  share that only one side decodes, over all sampled slots (%): LLRs,
  BP, CRC, OSD and the payload bytes.

Capture decodes (``decode_ft8_message``), per sampled call:

* ``score_gap``: the largest |score difference| of the rows both report;
* ``row_diff_pct``: of all the rows of both sides, the share without a
  twin on the other side (%): the same payload at the same time and
  frequency, its SNR within 0.1 dB (one step of the rows' rounding); a
  duplicated payload has no twin.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["compare_slots", "compare_rows", "within"]


def compare_slots(prog: dict, ref, score_limit: float, min_score: float
                  ) -> dict[str, float]:
    """``prog``: host numpy arrays (S, K) abs_time, abs_freq, score, valid,
    success and (S, K, 10) payload of the sampled slots; ``ref``: the
    reference's :class:`reference.decode.SlotDecode` of the same slots."""
    g = ref.grid
    scores = ref.scores.cpu().numpy()                       # (S, nT, nF)
    r_t, r_f = ref.abs_time.cpu().numpy(), ref.abs_freq.cpu().numpy()
    r_s, r_v = ref.score.cpu().numpy(), ref.valid.cpu().numpy()
    r_ok, r_pl = ref.success.cpu().numpy(), ref.payload.cpu().numpy()
    tie = 2.0 * score_limit
    gap, missed, diff, union = 0.0, 0, 0, 0
    for i in range(scores.shape[0]):
        ti = prog["abs_time"][i].astype(np.int64) - g.t_start
        fi = prog["abs_freq"][i].astype(np.int64)
        inside = (ti >= 0) & (ti < g.num_times) & (fi >= 0) \
            & (fi < g.num_freqs)
        at = np.full(ti.shape, -np.inf, np.float32)
        at[inside] = scores[i, ti[inside], fi[inside]]
        v = prog["valid"][i]
        if v.any():
            gap = max(gap, float(np.max(np.abs(
                np.where(np.isfinite(at[v]), prog["score"][i][v] - at[v],
                         np.inf)))))
        # the reference's K-th score; with fewer valid cells than K, every
        # cell at or above min_score is in its list
        kth = r_s[i][r_v[i]].min() if r_v[i].all() else min_score
        mine = set(zip(prog["abs_time"][i][v].tolist(),
                       prog["abs_freq"][i][v].tolist()))
        theirs = set(zip(r_t[i][r_v[i]].tolist(), r_f[i][r_v[i]].tolist()))
        missed += sum(1 for c, s in zip(zip(r_t[i].tolist(), r_f[i].tolist()),
                                        r_s[i]) if c in theirs
                      and c not in mine and s > kth + tie)
        missed += int(np.sum(v & ~np.array([c in theirs for c in zip(
            prog["abs_time"][i].tolist(), prog["abs_freq"][i].tolist())])
            & (at < kth - tie)))
        a = {bytes(p) for p in prog["payload"][i][prog["success"][i]]}
        b = {bytes(p) for p in r_pl[i][r_ok[i]]}
        diff += len(a ^ b)
        union += len(a | b)
    return {"score_gap": gap, "topk_missed": float(missed),
            "decode_diff_pct": 100.0 * diff / max(union, 1)}


def compare_rows(prog_rows: list[list], ref_rows: list[list]
                 ) -> dict[str, float]:
    """Per sampled call, the program's rows and the reference's of the same
    capture, each a list of :class:`reference.decode.Row`."""
    gap, unmatched, total = 0.0, 0, 0
    for mine, theirs in zip(prog_rows, ref_rows):
        total += len(mine) + len(theirs)
        left = list(theirs)
        for r in mine:
            twin = next((q for q in left if q.payload == r.payload
                         and q.time_s == r.time_s and q.freq_hz == r.freq_hz
                         and r.snr_db is not None
                         and abs(q.snr_db - r.snr_db) <= 0.1 + 1e-9), None)
            if twin is None:
                unmatched += 1
                continue
            left.remove(twin)
            gap = max(gap, abs(r.score - twin.score))
        unmatched += len(left)
    return {"score_gap": gap, "row_diff_pct": 100.0 * unmatched / max(total, 1)}


def within(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(bool(numbers[k] <= limits[k]) for k in limits)


def slot_fields(res, rows: torch.Tensor) -> dict:
    """The sampled slots ``rows`` of a program SlotDecodeResult, as host
    numpy arrays."""
    pick = lambda a: a[rows].cpu().numpy()
    return {"abs_time": pick(res.abs_time), "abs_freq": pick(res.abs_freq),
            "score": pick(res.score), "valid": pick(res.candidate_valid),
            "success": pick(res.success), "payload": pick(res.payload)}
