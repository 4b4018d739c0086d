"""Every entry of BENCHMARK.json resolves to its files by name, and the file
keeps to the benchmark contract's shapes and limits."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "port_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"host API", "batch entry", "waterfall", "sync", "top-K", "LLRs",
          "BP + CRC", "OSD", "device"}


def _reader(folder: str, name: str):
    path = PB / folder / f"{name}.py"
    assert path.is_file(), path
    spec = importlib.util.spec_from_file_location("r_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and 1 <= len(conf["source"]) <= 200
    assert 1 <= len(conf["why"]) <= 200 and "\n" not in conf["why"]
    assert conf["file"] == f"port_bench/configs/{conf['name']}.json"
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert conf["reduced"] == []
    # the protocol's shapes, never cut
    assert (cfg["fs"], cfg["slot_s"], cfg["symbols"], cfg["tone_spacing_hz"],
            cfg["ldpc_n"], cfg["ldpc_k"]) == (12000, 15.0, 79, 6.25, 174, 91)
    assert set(cfg["assumed"]) <= set(cfg)
    assert {"decode_slots", "decode_ft8_message"} <= set(cfg["precision"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    importlib.import_module(f"port_bench.entries.{traffic['entry']}")
    limits = json.loads((PB / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    reported = [m for m in BENCH["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        _reader("end_to_end", metric["name"])
    else:
        assert metric["layer"] in LAYERS
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        _reader("metrics", metric["name"])


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
