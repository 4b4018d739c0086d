"""The readings that the limits of ``correct`` are set from.

    python3 port_bench/control.py --workload <cell> --program-seeds 1,2,... \\
        --control-seeds 101,102,103 [--calls N]

For each program seed: the cell's traffic (one pool batch), a warm call,
``--calls`` calls of the program as the window makes them, and the numbers
that the run compares (``compare.py``) on the seed's sample: the sound
runs' (lower) readings.  For each control seed: the plain reference put in
the program's place, computed one precision step below what the
configuration states (the DFT: fp8 e4m3 operands for bf16, float32 sums for
float64; everything from the power on in bfloat16 for float32), on the
same sample size, compared with the reference at the stated precision:
the control's (upper) readings.  One JSON line per seed and side, then a
summary line: the largest program reading and the smallest control
reading of each number.  Needs the card, as the runs do.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

__all__ = ["LOWER", "program_numbers", "control_numbers", "main"]

# the nearest precision below each stated DFT precision
LOWER = {"bf16": "fp8", "float64": "float32"}


def _entry(workload: str, seed: int, device, overrides: dict | None):
    from port_bench import run

    spec = run.cell(workload, overrides)
    mod = importlib.import_module(
        f"port_bench.entries.{spec['traffic']['entry']}")
    return spec, mod.Entry(spec["config"], spec["traffic"], seed, device)


def program_numbers(workload: str, seed: int, calls: int, device="cuda",
                    overrides: dict | None = None) -> dict:
    spec, entry = _entry(workload, seed, device, overrides)
    entry.warm()
    for i in range(calls):
        entry.call(i)
    precision = spec["config"]["precision"][entry.reference_precision_key]
    return entry.check(seed, spec["limits"], precision)


def control_numbers(workload: str, seed: int, device="cuda",
                    overrides: dict | None = None) -> dict:
    from port_bench import compare

    spec, entry = _entry(workload, seed, device, overrides)
    stated = spec["config"]["precision"][entry.reference_precision_key]
    low = LOWER[stated]
    if spec["traffic"]["entry"] == "slots":
        rng = np.random.default_rng([seed, 1])
        n = entry.units_per_call
        picks = [(0, int(s)) for s in np.sort(rng.choice(
            n, min(int(spec["traffic"]["sample"]), n), replace=False))]
        c = entry.reference_outputs(picks, low, torch.bfloat16)
        ctrl = {"abs_time": c.abs_time.cpu().numpy(),
                "abs_freq": c.abs_freq.cpu().numpy(),
                "score": c.score.cpu().numpy(), "valid": c.valid.cpu().numpy(),
                "success": c.success.cpu().numpy(),
                "payload": c.payload.cpu().numpy()}
        ref = entry.reference_outputs(picks, stated)
        return compare.compare_slots(ctrl, ref, spec["limits"]["score_gap"],
                                     float(spec["config"]["min_score"]))
    calls = list(range(min(int(spec["traffic"]["sample"]), len(entry.pool))))
    return compare.compare_rows(
        entry.reference_rows(calls, low, torch.bfloat16),
        entry.reference_rows(calls, stated))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args(argv)
    over = {"traffic": {"pool_batches": 1}}
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    lo, hi = {}, {}
    for seed in seeds(args.program_seeds):
        nums = program_numbers(args.workload, seed, args.calls, "cuda", over)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program", **nums}), flush=True)
        for k, v in nums.items():
            lo[k] = max(lo.get(k, v), v)
    for seed in seeds(args.control_seeds):
        nums = control_numbers(args.workload, seed, "cuda", over)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control", **nums}), flush=True)
        for k, v in nums.items():
            hi[k] = min(hi.get(k, v), v)
    print(json.dumps({"workload": args.workload, "program_max": lo,
                      "control_min": hi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
