"""BENCHMARK.json against the contract's form, and every file it names."""

import json
import re

from perfbench.harness.cell import ROOT, load_cell, load_manifest, reader_path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_names_and_units():
    m = load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and m["paths"] == ["perfbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for w in m["workloads"]:
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in m["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"]) and c["reduced"] == []
    for p in m["per_layer"]:
        assert TEXT.match(p["layer"])
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
    assert len(json.dumps(m)) < 64 * 1024


def test_bounds():
    m = load_manifest()
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])


def test_every_cell_finds_its_files():
    m = load_manifest()
    e2e = {e["name"] for e in m["end_to_end"]}
    for w in m["workloads"]:
        cell = load_cell(w["name"])
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.traffic["rate_metric"] in reported
        assert cell.per_layer, w["name"]
        assert all(v is not None for v in cell.limits.values()), w["name"]
        for p in cell.per_layer:
            assert reader_path(p["name"]).exists(), p["name"]
            assert p["moves"] in e2e
    for c in m["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
