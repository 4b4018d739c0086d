"""The readings that the limits of ``deepest.qso`` are set from.

    python3 port_bench/control_qso.py --program-seeds 1,2,... \\
        --control-seeds 101,102,103 [--calls 16]

For each program seed: the cell's traffic, a warm call, ``--calls`` calls
of the program as the window makes them, and the numbers that the run
compares on the seed's sample (``compare.compare_rows``): the sound runs'
(lower) readings.  For each control seed, on the first ``sample``
captures of the pool, two controls compared with the reference at the
configuration's stated precision:

* ``precision``: the reference one precision step down (float32 DFT sums,
  everything from the power on in bfloat16), as ``control.py``'s;
* ``no_ap``: the reference with every clamped hypothesis left out (no
  a-priori retry; of the a-priori coherent retry only the null
  hypothesis, the plain coherent branches), which shows whether the check
  sees the rows that the clamps decode.

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

WORKLOAD = "deepest.qso"


def control_numbers(seed: int, device="cuda",
                    overrides: dict | None = None) -> dict[str, dict]:
    """Each control's compared numbers on the seed's first captures."""
    from port_bench import compare, control

    spec, entry = control._entry(WORKLOAD, seed, device, overrides)
    stated = spec["config"]["precision"][entry.reference_precision_key]
    calls = list(range(min(int(spec["traffic"]["sample"]), len(entry.pool))))
    ref = entry.reference_rows(calls, stated)
    return {
        "precision": compare.compare_rows(entry.reference_rows(
            calls, control.LOWER[stated], torch.bfloat16), ref),
        "no_ap": compare.compare_rows(
            entry.reference_rows(calls, stated, ap=False), ref)}


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
        for side, nums in control_numbers(seed, "cuda").items():
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
