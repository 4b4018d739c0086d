"""The readers of the program's wait spans and counters, on hand-made
traces and counter dicts: each reads what its docstring says, and None
where its span or counter is absent (as on a program without them)."""

from __future__ import annotations

import importlib.util

import pytest

from conftest import ROOT
from port_bench import counters as pbc
from port_bench.trace import CALL_RANGE, Trace, reduce_events


def _reader(name: str):
    path = ROOT / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "w_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _trace(stage_host_s=None, idle_by_range=None, calls=2,
           window_s=0.5) -> Trace:
    return Trace(calls=calls, window_s=window_s, busy_s=0.1, launches=10,
                 stage_host_s=stage_host_s or {}, outside_host_s=0.01,
                 kernel_s={}, kernel_launches={},
                 idle_by_range=idle_by_range or {})


WAITED = _trace({"decode": 0.030, "decode.wait": 0.010, "llrs": 0.02,
                 "llrs.wait": 0.004},
                {"ft8.decode.wait": 0.2, "ft8.llrs.wait": 0.05,
                 "ft8.decode": 0.1})


@pytest.mark.parametrize("name,want", [
    ("bp_wait_ms.batch", 5.0), ("bp_wait_ms.station", 5.0),
    ("llrs_wait_ms.batch", 2.0),
    ("wait_idle_pct.batch", 50.0), ("wait_idle_pct.station", 50.0),
])
def test_span_readers(name, want):
    read = _reader(name)
    assert read(WAITED, {}) == pytest.approx(want)
    # a program without wait spans: the stages only
    assert read(_trace({"decode": 0.03, "llrs": 0.02},
                       {"ft8.decode": 0.3}), {}) is None


COUNTS = {"waits": 260, "bp.calls": 2, "bp.iterations": 40, "slots": 512,
          "candidates.rows": 20480, "candidates.valid": 5120,
          "osd.rows": 1024, "osd.accepted": 64}


@pytest.mark.parametrize("name,want,needs", [
    ("host_waits.batch", 130.0, "waits"),
    ("host_waits.station", 130.0, "waits"),
    ("bp_iterations.batch", 20.0, "bp.iterations"),
    ("bp_iterations.station", 20.0, "bp.calls"),
    ("valid_pct.batch", 25.0, "candidates.valid"),
    ("osd_rows.batch", 2.0, "slots"),
    ("osd_accept_pct.batch", 6.25, "osd.accepted"),
])
def test_counter_readers(monkeypatch, name, want, needs):
    read = _reader(name)
    monkeypatch.setattr(pbc, "traced", lambda: dict(COUNTS))
    assert read(_trace(), {}) == pytest.approx(want)
    monkeypatch.setattr(pbc, "traced", lambda: {
        k: v for k, v in COUNTS.items() if k != needs})
    assert read(_trace(), {}) is None
    monkeypatch.setattr(pbc, "traced", lambda: None)
    assert read(_trace(), {}) is None


def test_counters_of_a_program_without_them(monkeypatch):
    from ft8_demodulator_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert pbc.traced() is None
    assert _reader("host_waits.batch")(_trace(), {}) is None


def test_counters_read_the_programs_traced_totals():
    import torch

    from ft8_demodulator_tpu_torch.utils import profiling

    profiling.reset_counters()
    profiling.count("waits", 3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("waits", 2)
        profiling.count_on_card("candidates.valid",
                                torch.tensor([True, False, True]))
    try:
        assert pbc.traced() == {"waits": 2, "candidates.valid": 2}
        assert pbc.per_call(_trace(calls=2), "waits") == 1.0
    finally:
        profiling.reset_counters()


def test_idle_opened_in_a_wait_is_named_after_it():
    """A gap that opens while the host is inside ft8.decode.wait (nested
    in ft8.decode) is the wait's, and wait_idle_pct reads it."""
    def x(name, ts, dur, cat="user_annotation"):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}

    events = [x(CALL_RANGE, 0, 1000), x("ft8.decode", 100, 800),
              x("ft8.decode.wait", 400, 200),
              x("kern", 0, 450, "kernel"), x("kern", 950, 50, "kernel")]
    t = reduce_events(events)
    assert t.idle_by_range == {"ft8.decode.wait": pytest.approx(500e-6)}
    assert t.stage_host_s["decode"] == pytest.approx(600e-6)
    assert _reader("wait_idle_pct.batch")(t, {}) == pytest.approx(50.0)
    assert _reader("bp_wait_ms.batch")(t, {}) == pytest.approx(0.2)
