"""The readers of BP's per-row iterations, on hand-made counter dicts:
``bp.row_iterations`` over ``bp.rows``, and None where either counter is
absent (as on a program that does not count them) or no row ran."""

from __future__ import annotations

import importlib.util

import pytest

from conftest import ROOT
from port_bench import counters as pbc
from port_bench.trace import Trace


def _reader(name: str):
    path = ROOT / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bp_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


TRACE = Trace(calls=3, window_s=0.5, busy_s=0.1, launches=10,
              stage_host_s={}, outside_host_s=0.01, kernel_s={},
              kernel_launches={}, idle_by_range={})
COUNTS = {"bp.calls": 3, "bp.rows": 15360, "bp.iterations": 60,
          "bp.row_iterations": 122880, "k7.launches": 3}


@pytest.mark.parametrize("name", ["bp_row_iterations.batch",
                                  "bp_row_iterations.station"])
@pytest.mark.parametrize("absent", [None, "bp.row_iterations", "bp.rows"])
def test_row_iteration_readers(monkeypatch, name, absent):
    read = _reader(name)
    monkeypatch.setattr(pbc, "traced", lambda: {
        k: v for k, v in COUNTS.items() if k != absent})
    if absent is None:
        assert read(TRACE, {}) == pytest.approx(8.0)
    else:
        assert read(TRACE, {}) is None


@pytest.mark.parametrize("name", ["bp_row_iterations.batch",
                                  "bp_row_iterations.station"])
def test_row_iteration_readers_without_rows_or_counters(monkeypatch, name):
    read = _reader(name)
    monkeypatch.setattr(pbc, "traced", lambda: dict(COUNTS, **{"bp.rows": 0}))
    assert read(TRACE, {}) is None
    monkeypatch.setattr(pbc, "traced", lambda: None)
    assert read(TRACE, {}) is None
