"""The beacon cell (``beacon.pass``): its files, its traffic, its entry and
check on the CPU at a tiny size (a fault planted in the program comes out
not correct, the control fails the limits), and its readers on hand-made
traces and counters."""

from __future__ import annotations

import importlib.util
import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import control_beacon, passes, run
from port_bench import compare
from port_bench import counters as pbc
from port_bench.entries import beacon
from port_bench.trace import Trace
from test_port_bench_imports import _modules_after

CELL = "beacon.pass"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# three cycles a pass (the middle one strong enough to lock and decode),
# one pass, a ring of two
TINY = {"traffic": {"cycles_per_pass": 3, "pool_passes": 1,
                    "snr_db_ends": -6.0, "snr_db_middle": -2.0},
        "config": {"max_repeats": 2}}
READERS = ["drift_ms.beacon", "stack_ms.beacon", "sync_z_ms.beacon",
           "coherent_ms.beacon", "osd_ms.beacon", "api_host_ms.beacon",
           "host_waits.beacon", "idle_pct.beacon", "drift_locked_pct.beacon",
           "coherent_accept_pct.beacon", "decode_ms.beacon",
           "bp_row_iterations.beacon", "wait_idle_pct.beacon"]


def _reader(name: str):
    path = ROOT / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "b_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_beacon_reference_loads_nothing_of_the_program():
    loaded = _modules_after(
        "import port_bench.reference.drift, port_bench.reference.stack, "
        "port_bench.passes")
    assert "port_bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "ft8_demodulator_tpu",
                         "ft8_demodulator_tpu_torch"}


def test_benchmark_entries():
    conf = next(c for c in BENCH["configs"] if c["name"] == "beacon")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["source"] == conf["source"] and len(conf["source"]) <= 200
    assert (cfg["fs"], cfg["max_repeats"], cfg["min_z"]) == (20000, 8, 2.0)
    assert set(cfg["assumed"]) <= set(cfg) and conf["reduced"] == []
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("beacon", "pass", 1)
    p95 = next(m for m in BENCH["end_to_end"]
               if m["name"] == "latency_ms_p95")
    assert CELL in p95["workloads"]
    mine = [m for m in BENCH["per_layer"] if CELL in m["workloads"]]
    assert sorted(m["name"] for m in mine) == sorted(READERS)
    assert all(m["workloads"] == [CELL] and m["moves"] == "latency_ms_p95"
               for m in mine)
    limits = json.loads((ROOT / "port_bench/limits/beacon.pass.json")
                        .read_text())
    assert set(limits) == {"score_gap", "row_diff_pct", "first_cycle_gap",
                           "models_differ", "sync_ties", "ring_gap"}


def test_pass_traffic():
    traffic = json.loads((ROOT / "port_bench/traffic/pass.json").read_text())
    assert traffic["entry"] == "beacon"
    assert traffic["fs"] * traffic["cycle_s"] == 6 * traffic["feed_samples"]
    snr = passes.snr_profile(traffic)
    assert len(snr) == 40 and snr[0] == snr[-1] == -16.0
    assert snr.max() == pytest.approx(-4.0, abs=0.01)
    small = dict(traffic, cycles_per_pass=2, pool_passes=2)
    a = passes.make_passes(small, 2 ** 31 + 7, "cpu")
    b = passes.make_passes(small, 2 ** 31 + 7, "cpu")
    c = passes.make_passes(small, 2 ** 31 + 8, "cpu")
    assert np.array_equal(a[1].audio, b[1].audio)
    assert not np.array_equal(a[1].audio, c[1].audio)
    for p in a:
        assert p.audio.shape == (2, 300000) and p.audio.dtype == np.float32
        assert abs(p.carrier_hz - 550.0) <= 20.0
        assert 1.0 <= abs(p.drift_hz_per_s) <= 4.0
        assert ((0.2 <= p.start_s) & (p.start_s <= 1.0)).all()
        assert p.payload[9] & 7 == 0


def _altered(monkeypatch):
    from ft8_demodulator_tpu_torch.demod import stack

    finish = stack.finish_decode

    def altered(*a, **kw):
        res = finish(*a, **kw)
        return res._replace(payload=res.payload ^ torch.tensor(
            [0x80] + [0] * 9, dtype=torch.uint8, device=res.payload.device))

    monkeypatch.setattr(stack, "finish_decode", altered)


def _uncorrected(monkeypatch):
    """The corrector's second stage left out: the linear chirp stays."""
    from ft8_demodulator_tpu_torch.beacon import drift

    rotate = drift.apply_polynomial_drift

    def first_left_out(z, rate, acc, *a, **kw):
        return rotate(z, 0.0 if acc == 0.0 else rate, acc, *a, **kw)

    monkeypatch.setattr(drift, "apply_polynomial_drift", first_left_out)


@pytest.mark.parametrize("fault", [None, "altered", "uncorrected"])
def test_fault_is_not_correct(fault, monkeypatch):
    if fault == "altered":
        _altered(monkeypatch)
    elif fault == "uncorrected":
        _uncorrected(monkeypatch)
    out = run.run(CELL, 2 ** 31 + 17, 0.0, False, device="cpu",
                  overrides=TINY)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is (fault is None), out["checks"]


def test_control_fails_program_passes_cpu():
    limits = run.cell(CELL)["limits"]
    ctrl = control_beacon.control_numbers(CELL, 2 ** 31 + 23, "cpu", TINY)
    assert not compare.within(ctrl, limits), ctrl
    prog = control_beacon.program_numbers(CELL, 2 ** 31 + 29, "cpu", TINY)
    assert compare.within(prog, limits), prog


def test_compare_pass_counts_a_late_row_a_moved_ring_and_ties():
    """A payload first reported a cycle late is a row without a twin and a
    first-cycle gap of 1; a cycle whose corrector model differs is counted,
    and its ring cycle not measured; a tie the reference took is counted
    apart."""
    row = lambda t: beacon.ref_decode.Row(b"p" * 10, t, 550.0, 9.0, -8.0)
    model = beacon.ref_stack.drift.Model((2, 100), 1.0, -3, 0.1, 0.0)

    class Ref:
        cfg = {"steps_per_symbol": 2}
        cycles = [torch.ones(4, dtype=torch.complex64)] * 2
        models = [model, model._replace(tied=True), model]

    ring = np.full((2, 4), 3.0, np.complex128)
    seen = beacon.model_s(model, 2)
    out = beacon.compare_pass([[], [row(15.5)], []], [[row(0.5)], [], []],
                              ring, [seen, seen, (None, None)], Ref())
    assert out["first_cycle_gap"] == 1.0 and out["row_diff_pct"] == 100.0
    assert out["models_differ"] == 1.0 and out["sync_ties"] == 1.0
    assert out["ring_gap"] == pytest.approx(2.0)


def _trace(stage_host_s=None, calls=8, window_s=1.0) -> Trace:
    return Trace(calls=calls, window_s=window_s, busy_s=0.25, launches=10,
                 stage_host_s=stage_host_s or {}, outside_host_s=0.08,
                 kernel_s={}, kernel_launches={}, idle_by_range={})


@pytest.mark.parametrize("name,stage", [
    ("drift_ms.beacon", "drift"), ("stack_ms.beacon", "stack"),
    ("sync_z_ms.beacon", "sync_z"), ("coherent_ms.beacon", "coherent"),
    ("osd_ms.beacon", "osd"), ("decode_ms.beacon", "decode")])
def test_span_readers(name, stage):
    read = _reader(name)
    assert read(_trace({stage: 0.04, stage + ".wait": 1.0}), {}) == \
        pytest.approx(5.0)
    assert read(_trace({"rows": 0.04}), {}) is None


def test_trace_readers():
    assert _reader("api_host_ms.beacon")(_trace(), {}) == pytest.approx(10.0)
    assert _reader("idle_pct.beacon")(_trace(), {}) == pytest.approx(75.0)
    waited = _trace({"drift.wait": 0.1, "stack": 0.2})
    waited.idle_by_range.update({"ft8.drift.wait": 0.25, "ft8.stack": 0.5})
    read = _reader("wait_idle_pct.beacon")
    assert read(waited, {}) == pytest.approx(25.0)
    assert read(_trace({"stack": 0.2}), {}) is None


COUNTS = {"waits": 400, "drift.cycles": 8, "drift.locked": 2,
          "coherent.rows": 160, "coherent.accepted": 4, "bp.rows": 960,
          "bp.row_iterations": 7680}


@pytest.mark.parametrize("name,want,needs", [
    ("host_waits.beacon", 50.0, "waits"),
    ("drift_locked_pct.beacon", 25.0, "drift.cycles"),
    ("coherent_accept_pct.beacon", 2.5, "coherent.rows"),
    ("bp_row_iterations.beacon", 8.0, "bp.row_iterations")])
def test_counter_readers(monkeypatch, name, want, needs):
    read = _reader(name)
    monkeypatch.setattr(pbc, "traced", lambda: dict(COUNTS))
    assert read(_trace(), {}) == pytest.approx(want)
    monkeypatch.setattr(pbc, "traced", lambda: {
        k: v for k, v in COUNTS.items() if k != needs})
    assert read(_trace(), {}) is None
    monkeypatch.setattr(pbc, "traced", lambda: None)
    assert read(_trace(), {}) is None


def test_program_counts_what_the_readers_read():
    """One traced corrected cycle and stacked decode on the CPU counts the
    corrector's cycles and locks and the coherent retry's rows."""
    from ft8_demodulator_tpu_torch.demod import BeaconSession
    from ft8_demodulator_tpu_torch.utils import profiling

    traffic = dict(json.loads((ROOT / "port_bench/traffic/pass.json")
                              .read_text()), **TINY["traffic"])
    x = passes.make_passes(traffic, 2 ** 31 + 3, "cpu")[0].audio[1]
    s = BeaconSession(20000.0, max_repeats=2, use_osd=True, coherent=True,
                      correction=True, device="cpu")
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            s.feed(x)
        c = pbc.traced()
        assert c["drift.cycles"] == 1 and c["drift.locked"] == 1
        assert c["coherent.rows"] >= 1 and "coherent.accepted" in c
        assert c["waits"] >= 5
    finally:
        profiling.reset_counters()
    (model,) = s.drift_models
    assert model["segment_s"] is not None and model["sync_time_s"] is not None


def test_check_takes_the_timed_calls_models(monkeypatch):
    """The check compares the models of the calls that built the ring, as
    the session kept them, and runs the corrector again only for a program
    that does not keep them."""
    from ft8_demodulator_tpu_torch import beacon as pbeacon

    entry = object.__new__(beacon.Entry)
    entry.fs, entry.device = 20000.0, "cpu"
    entry.cfg = {"bins_per_tone": 2, "steps_per_symbol": 2}
    entry.pool = [passes.Pass(np.zeros((2, 8), np.float32), b"", 550.0,
                              1.0, np.zeros(2), np.zeros(2))]

    def rerun(*a, **kw):
        rerun.calls += 1
        return None, 0.0, {"segment_s": None, "sync_time_s": 0.25}

    rerun.calls = 0
    monkeypatch.setattr(pbeacon, "correct_frequency_drift", rerun)
    entry.models = {5: ((0.0, 1.0), 0.5), 6: (None, None)}
    assert entry.program_models(0, 5, 2) == [((0.0, 1.0), 0.5), (None, None)]
    assert rerun.calls == 0
    entry.models = {}
    assert entry.program_models(0, 5, 2) == [(None, 0.25)] * 2
    assert rerun.calls == 2


def test_a_tie_is_taken_and_nothing_else():
    """The reference's stage 3 takes a hinted frame whose correlation ties
    its maximum within the float32 pulse's margin, and no other."""
    from port_bench.reference import drift as rd

    tau = 2
    tpl = rd._template(tau)
    masked = np.zeros(4 * len(tpl))
    masked[len(tpl): 2 * len(tpl)] = tpl            # one clear peak
    best, tied = rd._sync_frame(masked, tau, None)
    assert not tied and rd._sync_frame(masked, tau, best) == (best, False)
    assert rd._sync_frame(masked, tau, best + 1) == (best, False)
    flat = np.zeros(4 * len(tpl))                   # every frame ties at 0
    first, _ = rd._sync_frame(flat, tau, None)
    assert rd._sync_frame(flat, tau, first + 7) == (first + 7, True)
