#!/usr/bin/env python3
"""One case of tests/test_torch_export_grad.py in a process of its own:

    python tests/torch_export_grad_worker.py CASE.json OUT_DIR

Each gradient-method artifact takes 10-50 s of CPU to trace, save and load
at the test's size, so the test runs its cases side by side, each in one of
these processes (torch and the port only, no JAX). A case is a JSON object:

* ``{"model": M, "method": m, "params": P.npz, "images": I.npy}``: exports
  M's artifact for m (``export_serving`` at the test's config, batch 2,
  beam 2, word buckets (2,)) into OUT_DIR/artifact, loads it
  (``ExportedCaptioner``) and explains the images. ``"jax_noise": N.npy``
  also loads it with the loader's SmoothGrad draws replaced by N's rows
  (the JAX package's draws) and explains them again; ``"isolation": true``
  loads it in a fresh process that must import no model code.
* ``{"cli": true}``: ``cli export-serving --with-explain --method
  guided_gradcam`` on the mini-Flickr30k fixture, then ``cli serve
  --exported`` answering one /explain request.

Writes OUT_DIR/result.json (words, tokens, the programs' op targets and
constant shapes, seconds) and OUT_DIR/result.npz (the explanation arrays,
``<field>_<image>``, with the prefix ``jax_`` for the JAX-noise run).
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lrp_imagecaptioning_torch import cli  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.infer import export  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.weights import load_params_npz  # noqa: E402

# tests/test_torch_export.py's size
SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
             img_feature_dim=128, sentence_length=5, image_size=(8, 8))
VOCAB = 16
BATCH = 2
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")
# what a process that serves an artifact must not import
MODEL_MODULES = ("lrp_imagecaptioning_torch.models", "lrp_imagecaptioning_torch.explain",
                 "lrp_imagecaptioning_torch.config", "lrp_imagecaptioning_torch.data",
                 "lrp_imagecaptioning_tpu", "jax")


class PP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}
    word_of[1], word_of[2] = "szeros", "zeros"


def _programs(ec) -> dict:
    """Each loaded program's op targets and constant tensors' shapes."""
    return {str(w): {"targets": sorted({str(n.target) for n in p.graph.nodes
                                        if n.op == "call_function"}),
                     "constants": [list(t.shape) for t in p.constants.values()
                                   if isinstance(t, torch.Tensor)]}
            for w, p in ec.programs.items()}


def _explain(ec, images, prefix, arrays) -> list:
    out = ec.explain(images)
    for b, e in enumerate(out):
        for name in FIELDS:
            arrays[f"{prefix}{name}_{b}"] = e[name]
    return [{"caption": e["caption"], "words": e["words"],
             "tokens": [int(t) for t in e["tokens_1based"]]} for e in out]


def _isolated_load(art: str) -> dict:
    code = ("import sys\n"
            "import numpy as np\n"
            "from lrp_imagecaptioning_torch.infer.export import ExportedService\n"
            f"svc = ExportedService({art!r}, device='cpu')\n"
            f"out = svc.dispatch(np.zeros((1, 8, 8, 3), np.float32), explain=True)\n"
            "assert out[0].relevance_maps.shape[1:] == (8, 8, 3)\n"
            f"bad = sorted(m for m in sys.modules if m.startswith({MODEL_MODULES!r}))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    return {"rc": proc.returncode, "output": (proc.stdout + proc.stderr)[-2000:]}


def run_method(case: dict, out: str) -> tuple[dict, dict]:
    cap = build_captioner(case["model"], FlickrConfig(**SMALL), VOCAB)
    params = load_params_npz(case["params"], device="cpu")
    images = np.load(case["images"])
    art = os.path.join(out, "artifact")
    t0 = time.perf_counter()
    export.export_serving(cap, params, PP(), art, batch_size=BATCH, beam_size=2,
                          method=case["method"], word_buckets=(2,), device="cpu")
    t1 = time.perf_counter()
    ec = export.ExportedCaptioner(art, device="cpu")
    arrays = {}
    res = {"seconds": {"export": t1 - t0, "load": time.perf_counter() - t1}, "meta": ec.meta,
           "explain": _explain(ec, images, "", arrays), "programs": _programs(ec)}
    if case.get("jax_noise"):
        noise = torch.from_numpy(np.load(case["jax_noise"]))
        export.smoothgrad_noise = lambda rows, samples, shape: noise[:rows, :samples]
        res["jax_explain"] = _explain(export.ExportedCaptioner(art, device="cpu"), images,
                                      "jax_", arrays)
    if case.get("isolation"):
        res["isolation"] = _isolated_load(art)
    return res, arrays


def run_cli(out: str) -> tuple[dict, dict]:
    """export-serving and serve --exported on the mini fixture, as a user runs them."""
    import socket
    import urllib.request

    from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k

    os.chdir(out)
    write_mini_flickr30k("mini")
    argv = ["export-serving", "--dataset-root", "mini", "--batch-size", str(BATCH),
            "--device", "cpu", "--beam-size", "2", "--out", "art", "--with-explain",
            "--method", "guided_gradcam"]
    for kv in ("image_size=8,8", "layer_name=block2_conv1", "img_feature_length=16",
               "img_feature_dim=128", "embedding_dim=16", "hidden_dim=16", "sentence_length=5",
               "words_min_occur=1", "rare_words_handling=nothing"):
        argv += ["--set", kv]
    cli.main(argv)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = threading.Thread(target=cli.main, args=(
        ["serve", "--exported", "art", "--with-explain", "--device", "cpu", "--port", str(port),
         "--serve-seconds", "3"],))
    server.start()
    image = (np.random.default_rng(6).normal(size=(1, 8, 8, 3)) * 40).astype(np.float32)
    base = f"http://127.0.0.1:{port}"
    for _ in range(1200):
        try:
            urllib.request.urlopen(f"{base}/healthz", timeout=2).close()
            break
        except OSError:
            time.sleep(0.1)
    req = urllib.request.Request(f"{base}/explain",
                                 data=json.dumps({"images": image.tolist()}).encode(),
                                 headers={"Content-Type": "application/json"})
    import io

    with urllib.request.urlopen(req, timeout=120) as r:
        z = np.load(io.BytesIO(r.read()), allow_pickle=False)
        answer = {"caption": str(z["caption_0"]), "maps": z["relevance_maps_0"]}
    server.join(timeout=120)
    with open(os.path.join("art", "meta.json")) as f:
        meta = json.load(f)
    direct = export.ExportedCaptioner("art", device="cpu").explain(image)[0]
    return ({"meta": meta, "caption": answer["caption"], "direct_caption": direct["caption"],
             "server_stopped": not server.is_alive()},
            {"maps": answer["maps"], "direct_maps": direct["relevance_maps"]})


def main(argv=None) -> int:
    case_path, out = argv or sys.argv[1:]
    torch.set_num_threads(1)
    with open(case_path) as f:
        case = json.load(f)
    os.makedirs(out, exist_ok=True)
    res, arrays = run_cli(out) if case.get("cli") else run_method(case, out)
    np.savez(os.path.join(out, "result.npz"), **arrays)
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
