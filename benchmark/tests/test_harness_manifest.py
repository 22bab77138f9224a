"""BENCHMARK.json: names and units, and every cell's configuration,
traffic, limits and per-layer readers found by name."""

from __future__ import annotations

import re

import pytest

from benchmark import harness

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [m["name"] for m in metrics + MANIFEST["configs"]
             + MANIFEST["workloads"]]
    names += [w[k] for w in MANIFEST["workloads"] for k in ("config",
                                                             "traffic")]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in [w["why"] for w in MANIFEST["workloads"]] + \
            [c["why"] for c in MANIFEST["configs"]] + \
            [m["layer"] for m in MANIFEST["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in MANIFEST["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    files = harness.cell_files(MANIFEST, cell)
    assert "setup_s" in files["end_to_end"] and len(files["end_to_end"]) >= 2
    assert files["per_layer"]
    assert files["config"]["reduced"] == []
    assert files["traffic"]["driver"] in ("serve", "train")
    units = {m["name"]: m["unit"] for m in MANIFEST["per_layer"]}
    for name in files["per_layer"]:
        assert harness.load_reader(name).UNIT == units[name]


def test_configs_match_their_files():
    for c in MANIFEST["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_every_reader_has_an_entry():
    readers = {p.stem for p in (harness.HERE / "layer_metrics").glob("*.py")}
    assert readers == {m["name"] for m in MANIFEST["per_layer"]}
