"""Run one cell of the benchmark of ft8_demodulator_tpu_torch once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name: the cell in ``BENCHMARK.json``, the
configuration in ``port_bench/configs/<config>.json``, the traffic in
``port_bench/traffic/<traffic>.json``, the entry it drives in
``port_bench/entries/<entry>.py``, the limits of its check in
``port_bench/limits/<cell>.json``, each end-to-end metric's reader in
``port_bench/end_to_end/<metric>.py`` and each per-layer metric's in
``port_bench/metrics/<metric>.py``.

Set-up (timed as ``setup_s`` from the start of this process) makes the
traffic on the card from the seed and warms every shape the cell uses; the
window is a closed loop of calls for ``--seconds``.  With ``--trace 1`` a
few calls of the window run under ``torch.profiler``, and the line carries
the per-layer metrics instead of the end-to-end ones.  After the window the
plain reference decodes a sample of what the window produced, and
``correct`` says whether every compared number is within its limit.

The last line of standard output is one JSON object; the compared numbers
and their limits are also the last lines of standard error.  Without a
CUDA card, or with fewer than the cell asks for, it prints no result and
exits 2; if JAX or the JAX package is loaded once the window has closed,
it names it and exits 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "port_bench"
# the build and kernel caches of whatever the run loads, at fixed paths
# inside the checkout
CACHE = ROOT / ".port_bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "ft8_demodulator_tpu")

__all__ = ["Window", "cell", "run", "main"]


class Window(NamedTuple):
    """What the end-to-end readers read."""

    setup_s: float
    elapsed_s: float
    units: int                 # slots or captures completed
    latencies_s: list          # one per completed call


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def _for_cell(metric: dict, workload: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell(workload: str, overrides: dict | None = None) -> dict:
    """The cell's entries of BENCHMARK.json and its files, by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic, "limits": limits}[key] \
            .update(part)
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, workload, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _for_cell(m, workload, names)]
    return dict(workload=wl, config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=layer)


def _window(entry, seconds: float, trace_at: int | None, trace_calls: int):
    """The closed loop: calls until ``seconds`` have passed (at least one,
    and with ``trace_at`` until the traced calls have run).  Returns (elapsed s,
    units, latencies, attempted, failed, trace events or None)."""
    from . import trace as tr

    units, lat, attempted, failed, events = 0, [], 0, 0, None
    t_start = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter()
        if i and now - t_start >= seconds and (trace_at is None
                                               or events is not None):
            break
        if trace_at is not None and events is None and i >= trace_at:
            done = []
            events = tr.record(lambda k: done.append(entry.call(k)),
                               range(i, i + trace_calls))
            units += sum(done)
            attempted += trace_calls
            i += trace_calls
            continue
        attempted += 1
        try:
            t0 = time.perf_counter()
            units += entry.call(i)
            lat.append(time.perf_counter() - t0)
        except Exception as exc:  # a failed call counts against attempted
            failed += 1
            print(f"call {i} failed: {exc!r}", file=sys.stderr)
        i += 1
    return time.perf_counter() - t_start, units, lat, attempted, failed, \
        events


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: dict | None = None,
        t0: float = _T0) -> dict:
    """One run of the cell: the result line as a dict, "checks" last.
    ``t0``: the process's start on ``time.perf_counter``, where set-up
    begins."""
    import torch

    from . import compare
    from . import trace as tr

    spec = cell(workload, overrides)
    cfg, traffic = spec["config"], spec["traffic"]
    seed = int(seed) % 2 ** 63
    entry_mod = importlib.import_module(
        f"port_bench.entries.{traffic['entry']}")
    t_imported = time.perf_counter()
    entry = entry_mod.Entry(cfg, traffic, seed, torch.device(device))
    t_traffic = time.perf_counter()
    entry.warm()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"setup {setup_s:.3f} s: imports {t_imported - t0:.3f}, traffic "
          f"{t_traffic - t_imported:.3f}, warm-up "
          f"{t0 + setup_s - t_traffic:.3f}", file=sys.stderr)

    elapsed, units, lat, attempted, failed, events = _window(
        entry, seconds, 2 if trace else None,
        int(traffic.get("trace_calls", 3)))
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    window = Window(setup_s, elapsed, units, lat)

    metrics, breakdown, dev = {}, None, {
        "platform": "gpu" if device != "cpu" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        reduced = tr.reduce_events(events)
        ctx = {"bounds": entry.kernel_bounds(),
               "units_per_call": entry.units_per_call}
        for m in spec["per_layer"]:
            value = _load(HERE / "metrics" / f"{m['name']}.py",
                          f"port_bench_metric_{_safe(m['name'])}").read(
                              reduced, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        breakdown = {"device_ops": top(reduced.kernel_s),
                     "idle_gaps": top(reduced.idle_by_range)}
    else:
        for m in spec["end_to_end"]:
            value = _load(HERE / "end_to_end" / f"{m['name']}.py",
                          f"port_bench_e2e_{_safe(m['name'])}").read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    precision = cfg["precision"][entry.reference_precision_key]
    numbers = entry.check(seed, spec["limits"], precision) if units else {}
    correct = bool(units) and failed == 0 \
        and compare.within(numbers, spec["limits"])
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": numbers.get(k), "limit": v}
                     for k, v in spec["limits"].items()}
    return out


def main(argv=None, t0: float = _T0) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    # one process with one compute thread: host-side spin-waiting thread
    # pools add to the run-to-run spread of a host-bound decoder
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)

    chips = next(w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              t0=t0)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # run as the package's module, with the checkout's root (not this
    # folder) first on the path
    sys.path[0] = str(ROOT)
    from port_bench import run as _run

    sys.exit(_run.main(t0=_T0))
