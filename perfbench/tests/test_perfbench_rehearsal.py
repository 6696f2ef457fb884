"""Each cell rehearsed on the CPU at tiny shapes through the same entry,
traffic and metric files: sound, it comes out correct; with each fault the
cell can have planted in the timed path, it comes out not correct. The
result line holds only the contract's keys and the checks, last."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import run
from perfbench.harness.cell import BENCH, ROOT
from perfbench.tests.faults import FAULTS

# the rehearsal's own limits for a four-card training cell (CPU, tiny shapes)
FOUR_CARD_LIMITS = {"loss": 1e-3, "first_gradient": 5e-4, "change": 4e-2}
CONTRACT = {"correct", "attempted", "failed", "metrics", "device", "breakdown"}
SECONDS = {"adaptive-explain-natural": "8", "gridtd-train-k4": "4",
           "adaptive-finetune-k2": "4", "adaptive-train-dp4": "4"}


def rehearse(workload: str, seed: int, trace: int = 0) -> dict:
    out = {}
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", SECONDS[workload],
            "--trace", str(trace), "--rehearse"]
    assert run.main(argv, hooks={"result": out.update}) == 0
    return out


@pytest.fixture(scope="module")
def four_card_root(tmp_path_factory) -> Path:
    """A copy of the benchmark with a four-card training cell added as data
    (the mix ``train-dp4`` and a manifest entry), as a later PR would add it."""
    root = tmp_path_factory.mktemp("four_card")
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "lrp_imagecaptioning_torch", root / "lrp_imagecaptioning_torch")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "adaptive-train-dp4", "config": "flickr-vgg16-adaptive",
                                  "traffic": "train-dp4", "chips": 4, "why": "four ranks"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("adaptive-train-dp4")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / "perfbench" / "limits" / "adaptive-train-dp4.json").write_text(
        json.dumps(FOUR_CARD_LIMITS))
    return root


def rehearse_ranks(root: Path, workload: str, seed: int, fault: str, world: int = 4) -> dict:
    """The ranks of a several-card cell of the benchmark under ``root`` as
    gloo processes, ``fault`` planted in each; rank 0's result line."""
    port = run.free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(root / "perfbench" / "tests" / "rank_run.py"), fault, "--workload",
         workload, "--seed",
         str(seed), "--seconds", SECONDS[workload], "--trace", "0", "--rehearse", "--rank",
         str(r), "--world", str(world), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2")) for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["adaptive-explain-natural", "gridtd-train-k4",
                                      "adaptive-finetune-k2"])
def test_sound_rehearsal_is_correct(workload):
    result = rehearse(workload, 2**31 + 11)
    assert result["correct"] is True, result["checks"]
    assert set(result) - {"checks", "rehearsal"} <= CONTRACT
    assert list(result)[-1] == "checks" and result["metrics"] == {}


def test_traced_rehearsal_reads_no_device_metric():
    result = rehearse("gridtd-train-k4", 5, trace=1)
    assert result["correct"] is True and result["metrics"] == {}


@pytest.mark.parametrize("workload,fault", [
    ("adaptive-explain-natural", "map_altered"),
    ("adaptive-explain-natural", "token_altered"),
    ("gridtd-train-k4", "state_unchanged"),
    ("gridtd-train-k4", "half_batch"),
    ("adaptive-finetune-k2", "state_unchanged"),
    ("adaptive-finetune-k2", "half_batch"),
])
def test_fault_is_not_correct(workload, fault):
    undo = FAULTS[fault]()
    try:
        result = rehearse(workload, 77)
    finally:
        undo()
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault,correct", [("none", True), ("no_exchange", False),
                                           ("half_batch", False), ("state_unchanged", False)])
def test_four_ranks(four_card_root, fault, correct):
    result = rehearse_ranks(four_card_root, "adaptive-train-dp4", 31, fault)
    assert result["correct"] is correct, result["checks"]


def test_each_rank_gets_its_entry_of_the_cards_given():
    assert run.rank_devices({"CUDA_VISIBLE_DEVICES": "5,6"}, 2) == ["5", "6"]
    assert run.rank_devices({}, 4) == ["0", "1", "2", "3"]
    with pytest.raises(ValueError):
        run.rank_devices({"CUDA_VISIBLE_DEVICES": "5,6"}, 4)


def test_launch_gives_rank_r_card_r_of_the_set(monkeypatch):
    seen = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, env, **kwargs):
            seen.append((cmd[cmd.index("--rank") + 1], env["CUDA_VISIBLE_DEVICES"]))

        def communicate(self):
            return "", ""

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,6")
    monkeypatch.setattr(run.subprocess, "Popen", Proc)
    args = SimpleNamespace(workload="w", seed=1, seconds=1.0, trace=0, rehearse=False)
    assert run.launch_ranks(args, 2) == 0
    assert seen == [("0", "5"), ("1", "6")]
    seen.clear()
    assert run.launch_ranks(args, 4) != 0 and seen == []


def test_traced_training_window_profiles_whole_calls():
    """The armed profiler's stretch on the CPU: it holds the planned calls,
    and the window goes on to its end after it."""
    import torch

    from perfbench.entries.train import Entry
    from perfbench.harness.cell import load_cell
    from perfbench.harness.trace import Tracer

    entry = Entry(load_cell("gridtd-train-k4", rehearsal=True), 3, torch.device("cpu"))
    entry.trace_calls = (1, 3)
    tracer = Tracer(True)
    out = entry.window(1.0, tracer)
    assert entry.traced_calls == 2 and len(out["call_ends_s"]) >= 3
    s = tracer.summary
    assert 0 < s.window_s < out["call_ends_s"][-1] and s.host_span_s("aten::") > 0
    entry.release()
