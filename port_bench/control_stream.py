"""The readings that the limits of ``stream.feed`` are set from.

    python3 port_bench/control_stream.py --program-seeds 1,2,... \\
        --control-seeds 101,102,103 [--calls 16]

For each program seed: the cell's traffic, the warm-up, ``--calls`` calls
of the program as the window makes them, and the numbers that the run
compares on the seed's samples (the entry's check): the sound runs'
(lower) readings.  For each control seed, on the samples that a window of
``--calls`` calls would compare, two controls compared with the reference
at the configuration's stated precision:

* ``precision``: the reference one precision step down (float32 DFT sums,
  everything from the power on in bfloat16), as ``control.py``'s;
* ``no_lookahead``: the reference with every block its own 15 s,
  zero-padded, so a transmission that straddles a block edge loses its
  tail, which shows whether the check sees the rows the lookahead
  decodes.

One JSON line per seed and side, then a summary line: the largest program
reading and each control's smallest reading of each number.  Needs the
card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

__all__ = ["WORKLOAD", "control_numbers", "main"]

WORKLOAD = "stream.feed"


def control_numbers(seed: int, calls: int, device="cuda",
                    overrides: dict | None = None) -> dict[str, dict]:
    """Each control's compared numbers on the samples of a window of
    ``calls`` calls."""
    from port_bench import compare, control
    from port_bench.entries.stream import dup_rows
    from port_bench.reference import stream as ref_stream

    spec, entry = control._entry(WORKLOAD, seed, device, overrides)
    stated = spec["config"]["precision"][entry.reference_precision_key]
    total = calls * entry.stream.call_len
    runs = entry.sample(seed, len(ref_stream.plan(total, entry.rules, False)))
    blocks = entry.compared(runs)
    ref = entry.reference_runs(runs, stated)[0]

    def numbers(rows: dict) -> dict:
        out = compare.compare_rows([rows[b] for b in blocks],
                                   [ref[b] for b in blocks])
        out["dup_rows"] = float(dup_rows([q for b in blocks
                                          for q in rows[b]]))
        return out

    return {
        "precision": numbers(entry.reference_runs(
            runs, control.LOWER[stated], torch.bfloat16)[0]),
        "no_lookahead": numbers(entry.reference_runs(
            runs, stated, lookahead=False)[0])}


def main(argv=None) -> int:
    from port_bench import control

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=16)
    args = ap.parse_args(argv)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    lo, hi = {}, {}
    for seed in seeds(args.program_seeds):
        nums = control.program_numbers(WORKLOAD, seed, args.calls, "cuda")
        print(json.dumps({"workload": WORKLOAD, "seed": seed,
                          "side": "program", **nums}), flush=True)
        for k, v in nums.items():
            lo[k] = max(lo.get(k, v), v)
    for seed in seeds(args.control_seeds):
        for side, nums in control_numbers(seed, args.calls, "cuda").items():
            print(json.dumps({"workload": WORKLOAD, "seed": seed,
                              "side": side, **nums}), flush=True)
            for k, v in nums.items():
                hi.setdefault(side, {})
                hi[side][k] = min(hi[side].get(k, v), v)
    print(json.dumps({"workload": WORKLOAD, "program_max": lo,
                      "control_min": hi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
