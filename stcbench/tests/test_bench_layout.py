"""BENCHMARK.json as data: every cell and metric resolves to its files by
name, within the limits its format sets."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

from stcbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["stcbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_cell_resolves(cell):
    spec = harness.resolve(cell["name"])
    assert spec["mix"]["kind"] == "ingest"
    fam = importlib.import_module(
        f"stcbench.families.{spec['config']['family']}")
    assert set(spec["limits"]) == set(fam.CHECK_NAMES)
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    # every per-layer metric moves an end-to-end metric this cell reports
    assert {m["moves"] for m in spec["per_layer"]} <= names


def test_configs_files():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("stcbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        reader = ROOT / "stcbench" / "metrics" / f"{m['name']}.py"
        sp = importlib.util.spec_from_file_location("r", reader)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        assert callable(mod.read)


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"Host pipeline", "Vision", "LM append",
                           "Kernels", "Device", "Whole step"}
