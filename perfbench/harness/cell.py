"""One cell of ``BENCHMARK.json``, found by name: the workload entry, its
configuration file, its traffic mix, its limits and the metrics it reports.
Every per-cell fact lives in a file named after the cell, the configuration
or the mix, so that a new cell is new files and new manifest entries."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from perfbench.reference.model import Sizes

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # perfbench/configs/<config>.json
    traffic: dict         # perfbench/traffic/<traffic>.json
    limits: dict          # perfbench/limits/<workload>.json: number -> limit
    end_to_end: list      # the manifest's end-to-end metrics this cell reports
    per_layer: list       # the manifest's per-layer metrics this cell reports

    @property
    def sizes(self) -> Sizes:
        c, m = self.config["model_config"], self.config
        return Sizes(model=m["model"], arch=c["img_encoder"], until=c["layer_name"],
                     E=c["embedding_dim"], H=c["hidden_dim"], L=c["img_feature_length"],
                     D=c["img_feature_dim"], V=m["vocab_size"], image=m["image_size"])


def reports(metric: dict, workload: str, e2e_of: set) -> bool:
    """Whether ``workload`` reports ``metric``: its ``workloads`` list when
    it has one, else every cell that reports the metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in e2e_of if "moves" in metric else True


def load_cell(name: str, rehearsal: bool = False, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest under ``root``; ``rehearsal``
    applies the configuration's and the mix's ``rehearsal`` overrides (tiny
    shapes for a run on the CPU)."""
    manifest = load_manifest(root)
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(work)}")
    w = work[name]
    bench = root / "perfbench"
    config = json.loads((bench / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    if rehearsal:
        config = _merge(config, config.get("rehearsal", {}))
        traffic = _merge(traffic, traffic.get("rehearsal", {}))
    e2e = [m for m in manifest["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if reports(m, name, names)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """``perfbench/layer_metrics/<metric>.py``, or, where there is none, the
    reader its family shares (the name up to its first dot: ``mfu.train``
    -> ``mfu.py``)."""
    folder = root / "perfbench" / "layer_metrics"
    path = folder / f"{metric}.py"
    return path if path.exists() else folder / f"{metric.split('.')[0]}.py"


def load_reader(metric: str, root: Path = ROOT):
    """``read(ctx)`` of the metric's reader (``reader_path``)."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
