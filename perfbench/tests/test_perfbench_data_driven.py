"""A new cell, traffic mix, configuration and per-layer metric take only new
files under perfbench/ and new entries in BENCHMARK.json: shown in a
temporary copy, where a throwaway cell is added that way and rehearsed."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench.harness.cell import BENCH, ROOT, load_cell, load_reader


def test_a_cell_added_by_new_files_only(tmp_path: Path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_*.sh"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    os.symlink(ROOT / "lrp_imagecaptioning_torch", tmp_path / "lrp_imagecaptioning_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    before[tmp_path / "BENCHMARK.json"] = (tmp_path / "BENCHMARK.json").read_bytes()

    bench = tmp_path / "perfbench"
    mix = json.loads((bench / "traffic" / "explain-natural.json").read_text())
    mix["lengths"] = {"mean": 14.0, "std": 2.0, "min": 8, "max": 20}
    (bench / "traffic" / "explain-long.json").write_text(json.dumps(mix))
    conf = json.loads((bench / "configs" / "flickr-vgg16-adaptive.json").read_text())
    conf["name"] = "flickr-vgg16-adaptive-copy"
    (bench / "configs" / "flickr-vgg16-adaptive-copy.json").write_text(json.dumps(conf))
    limits = json.loads((bench / "limits" / "adaptive-explain-natural.json").read_text())
    (bench / "limits" / "adaptive-explain-long.json").write_text(json.dumps(limits))
    (bench / "layer_metrics" / "words.explain.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][0], name="flickr-vgg16-adaptive-copy",
                                    file="perfbench/configs/flickr-vgg16-adaptive-copy.json"))
    manifest["workloads"].append({"name": "adaptive-explain-long",
                                  "config": "flickr-vgg16-adaptive-copy",
                                  "traffic": "explain-long", "chips": 1, "why": "longer"})
    manifest["end_to_end"][0]["workloads"].append("adaptive-explain-long")
    manifest["per_layer"].append({"name": "words.explain", "unit": "words", "better": "higher",
                                  "source": "program_counter", "layer": "graphs",
                                  "moves": "explained_img_per_s",
                                  "workloads": ["adaptive-explain-long"]})
    # a metric of a family that has its reader: a manifest entry alone
    manifest["per_layer"].append({"name": "device_idle.long", "unit": "%", "better": "lower",
                                  "source": "device_trace", "layer": "device",
                                  "moves": "explained_img_per_s",
                                  "workloads": ["adaptive-explain-long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    # no file that was there changed, but BENCHMARK.json's new entries
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    cell = load_cell("adaptive-explain-long", root=tmp_path)
    assert cell.traffic["lengths"]["mean"] == 14.0
    assert [m["name"] for m in cell.per_layer] == ["words.explain", "device_idle.long"]
    assert load_reader("words.explain", root=tmp_path)({}) == 1.0
    assert load_reader("device_idle.long", root=tmp_path)({"traces": []}) is None
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "adaptive-explain-long", "--seed", "4", "--seconds", "8", "--trace",
                           "0", "--rehearse"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True


def test_without_the_program_it_fails_and_prints_no_result(tmp_path: Path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gridtd-train-k4",
                           "--seed", "4", "--seconds", "4", "--trace", "0", "--rehearse"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout
