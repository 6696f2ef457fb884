"""PyTorch port: ``infer/export.py``, the ``torch.export`` serving artifact,
against the port's live service at the serving tests' small size
(tests/test_torch_serving.py), on params from the JAX package's init
(``params_from_jax``).

One artifact is exported for the module (batch 3, beam 2, buckets (2,) and
T), on the CPU. Its captions must equal the live ``CaptionService``'s and
its explanations the live ``Explainer``'s, tokens exact and every array
within 1e-6 of its scale (the programs run the live path's ops on the same
shapes). Loading it in a fresh process imports no model, explain or config
module of the port, as tests/test_export_serving.py holds for the JAX
artifact; ``serve --exported`` validates against ``meta.json`` before it
loads anything.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch import cli  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.infer.export import (ExportedCaptioner, ExportedService,  # noqa: E402
                                                    export_serving)
from lrp_imagecaptioning_torch.infer.serving import CaptionService  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
             img_feature_dim=128, sentence_length=5, image_size=(8, 8))
VOCAB = 16
RTOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX artifact's meta.json keys (lrp_imagecaptioning_tpu/infer/export.py:95-106)
META_KEYS = {"batch_size", "beam_size", "max_len", "image_size", "sos", "eos", "eos_word",
             "method", "buckets", "word_of"}
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")


class PP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}
    word_of[1], word_of[2] = "szeros", "zeros"


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    jcap = j_build("adaptiveattention", JConfig(drop_rate=0.0, **SMALL), VOCAB)
    params = params_from_jax(jcap.init_params(jax.random.PRNGKey(3)), "cpu")
    cap = t_build("adaptiveattention", TConfig(**SMALL), VOCAB)
    out = str(tmp_path_factory.mktemp("export") / "artifact")
    export_serving(cap, params, PP(), out, batch_size=3, beam_size=2, method="lrp",
                   word_buckets=(2,), device="cpu")
    return out, cap, params


@pytest.fixture(scope="module")
def service(artifact):
    """The artifact loaded once (loading deserializes every program)."""
    return ExportedService(artifact[0], warmup=False, device="cpu")


def _images(n, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, 8, 8, 3)) * 40).astype(np.float32)


def _rel(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if ref.size else 0.0
    return 0.0 if scale == 0 else float(np.abs(np.asarray(got) - ref).max() / scale)


def test_artifact_layout_and_meta(artifact):
    out, _, _ = artifact
    files = set(os.listdir(out))
    assert {"decode.pt2", "explain_w2.pt2", "explain_w5.pt2", "params.npz", "meta.json"} <= files
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == META_KEYS
    assert meta["batch_size"] == 3 and meta["eos"] == 2 and meta["buckets"] == [2, 5]
    assert meta["word_of"]["3"] == "w3" and meta["method"] == "lrp"
    with open(os.path.join(out, "export.json")) as f:
        report = json.load(f)
    assert set(report["bytes"]) == {"decode.pt2", "explain_w2.pt2", "explain_w5.pt2"}


def test_exported_caption_matches_live(artifact, service):
    """5 images through the batch-3 artifact (a chunk of 3, a padded 2)."""
    _, cap, params = artifact
    images = _images(5, seed=1)
    live = CaptionService(cap, params, PP(), batch_size=3, beam_size=2, device="cpu")
    assert service._ec.caption(images) == live.caption(images)


def test_exported_explain_matches_live(artifact, service):
    """Tokens exact and every explanation array within 1e-6 of its scale of
    the live Explainer's ``analyze_batch`` (same bucket rule), for a full
    and a padded chunk."""
    _, cap, params = artifact
    exported = service._ec
    ex = Explainer(cap, params, PP(), beam_size=2, word_buckets=(2,), batch_size=3, device="cpu")
    for n, seed in ((3, 2), (2, 3)):
        images = _images(n, seed)
        got, want = exported.explain(images), ex.analyze_batch(images)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert g["caption"] == w.caption and g["words"] == w.words
            np.testing.assert_array_equal(g["tokens_1based"], w.tokens_1based)
            for name in FIELDS:
                assert g[name].shape == getattr(w, name).shape, name
                assert _rel(g[name], getattr(w, name)) <= RTOL, name


def test_exported_chunks_keep_request_order(service):
    """7 images at batch 3: three chunks, the last padded, in request order."""
    exported = service._ec
    images = _images(7, seed=4)
    assert exported.caption(images) == [c for i in range(0, 7, 3)
                                        for c in exported.caption(images[i:i + 3])]
    got = exported.explain(images)
    want = [e for i in range(0, 7, 3) for e in exported.explain(images[i:i + 3])]
    assert [g["words"] for g in got] == [w["words"] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["relevance_maps"], w["relevance_maps"])


def test_exported_programs_call_the_kernel_ops(artifact):
    """The explain program reaches the kernels as ``lrpic::`` custom ops:
    K1 and K2 in the decoder stage, K3 in the f32 CNN LRP; the decode K2."""
    out, _, _ = artifact
    targets = {}
    for name in ("decode.pt2", "explain_w2.pt2"):
        program = torch.export.load(os.path.join(out, name))
        targets[name] = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "lrpic.lstm_gates.default" in targets["decode.pt2"]
    assert {"lrpic.lrp_linear.default", "lrpic.lstm_gates.default",
            "lrpic.conv3x3_fused.default"} <= targets["explain_w2.pt2"]


def test_loading_imports_no_model_code(artifact):
    """A fresh process loads the artifact and answers from it with torch,
    numpy and the kernels' module: no models, explain or config module."""
    out, _, _ = artifact
    code = ("import sys\n"
            "import numpy as np\n"
            "from lrp_imagecaptioning_torch.infer.export import ExportedService\n"
            f"svc = ExportedService({out!r}, device='cpu')\n"
            "caps = svc.dispatch(np.zeros((2, 8, 8, 3), np.float32))\n"
            "assert len(caps) == 2\n"
            "bad = sorted(m for m in sys.modules if m.startswith(('lrp_imagecaptioning_torch."
            "models', 'lrp_imagecaptioning_torch.explain', 'lrp_imagecaptioning_torch.config', "
            "'lrp_imagecaptioning_torch.data', 'lrp_imagecaptioning_tpu', 'jax')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_exported_service_dispatch(service):
    """The CaptionService-compatible facade: captions, explanations with the
    EOS word, stats, the method guard (None serves the artifact's own), the
    resolution the front-ends check."""
    svc = service
    images = _images(2, seed=5)
    requests, served = svc.stats["requests"], svc.stats["images"]
    caps = svc.dispatch(images)
    assert caps == svc._ec.caption(images)
    exps = svc.dispatch(images, explain=True, method="lrp")
    assert exps[0].caption == " ".join([*caps[0].split(), "zeros"])
    assert exps[0].relevance_maps.shape[1:] == (8, 8, 3)
    assert svc.stats["requests"] == requests + 2 and svc.stats["images"] == served + 4
    assert svc.dispatch(images, explain=True)[0].caption == exps[0].caption
    assert svc.expected_hw == (8, 8)
    with pytest.raises(ValueError):
        svc.dispatch(images, explain=True, method="gradient")


def test_exported_service_warmup_calls_every_program(service, monkeypatch):
    called = []
    slot, *rest = service._ec._slots
    monkeypatch.setattr(service._ec, "_slots", [slot._replace(explain={
        w: (lambda *x, _w=w, _f=f: called.append(_w) or _f(*x))
        for w, f in slot.explain.items()}), *rest])
    service.warmup()
    assert sorted(called) == [2, 5] and service.stats["warmup_s"] >= 0


def test_http_and_cli_serve_from_the_artifact(artifact, service):
    """``serve --exported DIR`` answers /caption and /explain over HTTP as
    the artifact does directly."""
    import socket

    out, _, _ = artifact
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = threading.Thread(target=cli.main, args=(
        ["serve", "--exported", out, "--with-explain", "--device", "cpu", "--port", str(port),
         "--serve-seconds", "2"],))
    server.start()
    base = f"http://127.0.0.1:{port}"
    images = _images(2, seed=6)
    try:
        for _ in range(600):
            try:
                urllib.request.urlopen(f"{base}/healthz", timeout=2).close()
                break
            except OSError:
                threading.Event().wait(0.1)
        req = urllib.request.Request(f"{base}/caption",
                                     data=json.dumps({"images": images.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            caps = json.load(r)["captions"]
        req = urllib.request.Request(f"{base}/explain",
                                     data=json.dumps({"images": images.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        import io

        with urllib.request.urlopen(req, timeout=60) as r:
            z = np.load(io.BytesIO(r.read()), allow_pickle=False)
            maps = z["relevance_maps_0"]
    finally:
        server.join(timeout=60)
    assert not server.is_alive()
    direct = service._ec
    assert caps == direct.caption(images)
    np.testing.assert_array_equal(maps, direct.explain(images)[0]["relevance_maps"]
                                  .astype(np.float16))


def test_serve_cli_validates_the_artifact_before_loading(artifact, tmp_path):
    """Flags that contradict meta.json exit at start-up: --with-explain on
    an artifact without explain programs, another --method than its own."""
    out, _, _ = artifact
    bare = tmp_path / "bare"
    bare.mkdir()
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    (bare / "meta.json").write_text(json.dumps(dict(meta, method=None, buckets=[])))
    with pytest.raises(SystemExit, match="without explain"):
        cli.main(["serve", "--exported", str(bare), "--with-explain", "--device", "cpu"])
    with pytest.raises(SystemExit, match="exported with method"):
        cli.main(["serve", "--exported", out, "--with-explain", "--method", "gradient",
                  "--device", "cpu"])


def test_cli_export_serving_writes_a_decode_artifact(tmp_path, monkeypatch):
    """``export-serving`` without --with-explain: the decode program, the
    params and the meta of the mini fixture's vocabulary."""
    from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k

    monkeypatch.chdir(tmp_path)
    write_mini_flickr30k("mini")
    argv = ["export-serving", "--dataset-root", "mini", "--batch-size", "2", "--device", "cpu",
            "--beam-size", "2", "--out", "art"]
    for kv in ("image_size=8,8", "layer_name=block2_conv1", "img_feature_length=16",
               "img_feature_dim=128", "embedding_dim=16", "hidden_dim=16", "sentence_length=5",
               "words_min_occur=1", "rare_words_handling=nothing"):
        argv += ["--set", kv]
    cli.main(argv)
    assert sorted(os.listdir("art")) == ["decode.pt2", "export.json", "meta.json", "params.npz"]
    assert len(ExportedCaptioner("art", device="cpu").caption(_images(3))) == 3
    shutil.rmtree("art")


def test_export_refuses_what_it_cannot_carry(artifact, tmp_path):
    """The gradient methods (autograd) do not export; more cards than there
    are raise the JAX facade's ValueError, and a device that does not exist
    raises too."""
    out, cap, params = artifact
    with pytest.raises(NotImplementedError, match="gradient"):
        export_serving(cap, params, PP(), str(tmp_path / "g"), method="gradient", device="cpu")
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for devices, exc, match in ((avail + 1, ValueError, "available"),
                                (["a", "b"], RuntimeError, "device")):
        with pytest.raises(exc, match=match):
            ExportedCaptioner(out, devices=devices, device="cpu")


def test_wrappers_route_to_the_custom_ops_only_while_exporting():
    """Outside an export a wrapper calls its route directly; the ops give
    the plain versions' results on the CPU."""
    gen = torch.Generator().manual_seed(0)
    r, z = torch.randn(4, 6, generator=gen), torch.randn(4, 6, generator=gen)
    x, w = torch.randn(4, 5, generator=gen), torch.randn(5, 6, generator=gen)
    assert not torch.compiler.is_exporting()
    torch.testing.assert_close(torch.ops.lrpic.lrp_linear(r, x, z, w),
                               kernels.lrp_linear(r, x, z, w), rtol=0, atol=0)
    zx, zh = torch.randn(2, 16, generator=gen), torch.randn(2, 16, generator=gen)
    b, c = torch.randn(16, generator=gen), torch.randn(2, 4, generator=gen)
    for a, e in zip(torch.ops.lrpic.lstm_gates(zx, zh, b, c), kernels.lstm_gates(zx, zh, b, c)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    xi, ew = torch.relu(torch.randn(1, 5, 5, 4, generator=gen)), torch.randn(3, 5, 5, 8,
                                                                             generator=gen)
    k, bias = torch.rand(3, 3, 4, 8, generator=gen), torch.rand(8, generator=gen)
    torch.testing.assert_close(torch.ops.lrpic.conv3x3_fused(xi, ew, k, bias, "divide"),
                               kernels.conv3x3_fused(xi, ew, k, bias, "divide"), rtol=0, atol=0)
    bf = torch.bfloat16
    torch.testing.assert_close(
        torch.ops.lrpic.lrp_a1b0_fused(ew.to(bf), xi.to(bf), k.to(bf), bias.to(bf)),
        kernels.lrp_a1b0_fused(ew.to(bf), xi.to(bf), k.to(bf), bias.to(bf)), rtol=0, atol=0)
