"""BENCHMARK.json against the manifest's format (keys, names, units,
bounds, the cells' metrics), and every configuration, traffic, driver and
metric file it names found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51
    assert isinstance(man["run_seconds"], int)
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert not p.endswith("_torch")
    assert len(man["command"]) <= 32
    for word in man["command"]:
        assert 1 <= len(word) <= 200 and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in man["paths"])
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_and_units(man):
    every = man["configs"] + man["workloads"] + man["end_to_end"] + \
        man["per_layer"]
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for text in (m.get("layer", "x"),):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_configs_found_by_name(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = ROOT / c["file"]
        assert f == BENCH / "configs" / f"{c['name']}.json"
        data = json.loads(f.read_text())
        assert data["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in data
            assert not k.endswith(("_dim", "_rank"))
        assert 1 <= len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_cells_found_by_name(man):
    pairs = set()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        t = json.loads((BENCH / "workloads" / f"{w['traffic']}.json")
                       .read_text())
        assert (BENCH / "drivers" / f"{t['driver']}.py").exists()
        mine = [m["name"] for m in man["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) == 2     # and its rate
        assert all(m in e2e for m in mine)
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in man["per_layer"])
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_metrics_found_by_name(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    layers = {}
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])


def test_limits_are_set(man):
    for w in man["workloads"]:
        t = json.loads((BENCH / "workloads" / f"{w['traffic']}.json")
                       .read_text())
        for k, v in t["limits"].items():
            assert 0 <= v < 1e6, (w["name"], k)
