"""The readings that the beacon cells' limits are set from.

    python3 port_bench/control_beacon.py --workload beacon.pass \\
        --program-seeds 1,2,... --control-seeds 101,102,103

For each program seed: the cell's traffic cut to one pass, a warm-up, the
pass's cycles through the program as the window runs them, and the numbers
that the run compares (``entries/beacon.py compare_pass``): the sound
runs' (lower) readings.  For each control seed: the plain reference one
precision step below the configuration's float32 (bfloat16 after the
analytic signal: the corrector's spectra, power, dB grid and rotations, the
stack's spectra, power, scores and correlations) in the program's place,
its own corrected ring and corrector models standing for the program's
(the models the float32 reference's hints), compared with the reference at
float32: the control's (upper) readings.  The same
output lines as ``control.py``: one JSON line per seed and side, then the
largest program reading and the smallest control reading of each number.
Needs the card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["LOWER", "program_numbers", "control_numbers", "main"]

# the nearest precision below the beacon path's stated one
LOWER = {"float32": "bf16"}


def program_numbers(workload: str, seed: int, device="cuda",
                    overrides: dict | None = None) -> dict:
    from port_bench.control import _entry

    spec, entry = _entry(workload, seed, device, overrides)
    entry.warm()
    for i in range(entry.cycles):
        entry.call(i)
    return entry.check(seed, spec["limits"],
                       spec["config"]["precision"]["beacon"])


def control_numbers(workload: str, seed: int, device="cuda",
                    overrides: dict | None = None) -> dict:
    from port_bench.control import _entry
    from port_bench.entries.beacon import compare_pass, model_s

    spec, entry = _entry(workload, seed, device, overrides)
    stated = spec["config"]["precision"]["beacon"]
    low_rows, low = entry.reference_session(0, entry.cycles, LOWER[stated])
    models = [model_s(m, spec["config"]["steps_per_symbol"])
              for m in low.models]
    rows, ref = entry.reference_session(0, entry.cycles, stated, models)
    ring = np.stack([z.cpu().numpy().astype(np.complex128)
                     for z in low.cycles])
    return compare_pass(low_rows, rows, ring, models, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    over = {"traffic": {"pool_passes": 1}}
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    lo, hi = {}, {}
    for seed in seeds(args.program_seeds):
        t0 = time.perf_counter()
        nums = program_numbers(args.workload, seed, "cuda", over)
        print(f"program seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program", **nums}), flush=True)
        for k, v in nums.items():
            lo[k] = max(lo.get(k, v), v)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        nums = control_numbers(args.workload, seed, "cuda", over)
        print(f"control seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
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
