"""PyTorch port: the gradient methods through the ``torch.export`` serving
artifact (``infer/export.py``: ``make_fx``, then ``torch.export``), at
tests/test_torch_export.py's size, on params from the JAX package's init
(``params_from_jax``), batch 2, beam 2, word buckets (2,) and T.

Exporting, saving and loading one such artifact takes 10-50 s of CPU, so
each is made, loaded and asked for explanations in a process of its own
(``tests/torch_export_grad_worker.py``), WORKERS side by side, while this
process runs the live Explainers and the JAX package's exports. Held:

* every gradient method on adaptive attention, and grid-TD and AOA (whose
  decoder gradient differentiates through K2's ``lrpic::lstm_gates``): the
  exported explain gives the live port Explainer's ``analyze_batch``
  tokens exactly and every array within 1e-6 of its scale;
* Guided-GradCAM, SmoothGrad and IG: the JAX package's own
  ``export_serving`` + ``ExportedCaptioner.explain`` at the same params,
  tokens equal and every array within 1e-4 of its scale (SmoothGrad with
  the JAX draws handed to the port's loader in place of its own);
* every program calls ``lrpic::lstm_gates``; SmoothGrad's noise is an
  input of its programs, not a constant;
* a SmoothGrad artifact loads and explains in a process that imports no
  model code; ``cli export-serving --with-explain --method guided_gradcam``
  and ``cli serve --exported`` answer /explain.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import torch_encoders as te  # noqa: E402
import torch_export_grad_worker as worker  # noqa: E402
from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.infer.export import ExportedCaptioner as JExported  # noqa: E402
from lrp_imagecaptioning_tpu.infer.export import export_serving as j_export  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import METHODS, Explainer  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, save_params_npz  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GRADIENT_METHODS = tuple(m for m in METHODS if m not in ("lrp", "deep_taylor", "deep_lift"))
JAX_METHODS = ("guided_gradcam", "smoothgrad", "integrated_gradients")
OTHER_MODELS = {"gridTD": "guided_backprop", "aoa": "gradient"}
RTOL = 1e-6
MAP_RTOL = 1e-4   # tests/test_torch_gradient.py
K2 = "lrpic.lstm_gates.default"
WORKERS = 6   # worker processes at a time: the file takes ~75 s on 8 cores
# the JAX artifact's meta.json keys (lrp_imagecaptioning_tpu/infer/export.py:95-106)
META_KEYS = {"batch_size", "beam_size", "max_len", "image_size", "sos", "eos", "eos_word",
             "method", "buckets", "word_of"}
FIELDS = worker.FIELDS
PP = worker.PP
# the slowest first: IG's 16 and SmoothGrad's 8 passes an image
CASES = ([("adaptiveattention", m) for m in ("integrated_gradients", "smoothgrad")]
         + [("cli", None)] + [(model, m) for model, m in OTHER_MODELS.items()]
         + [("adaptiveattention", m) for m in GRADIENT_METHODS
            if m not in ("integrated_gradients", "smoothgrad")])


def _images(n=worker.BATCH, seed=2):
    return (np.random.default_rng(seed).normal(size=(n, 8, 8, 3)) * 40).astype(np.float32)


def _rel(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if ref.size else 0.0
    return 0.0 if scale == 0 else float(np.abs(np.asarray(got) - ref).max() / scale)


def _name(model, method):
    return "cli" if model == "cli" else f"{model}-{method}"


def _run(case_path, out):
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_export_grad_worker.py"),
                           case_path, out], capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=os.path.dirname(HERE)))
    return proc.returncode, (proc.stdout + proc.stderr)[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's worker result, the live port Explainer's explanations and
    (JAX_METHODS) the JAX package's exported ones."""
    root = tmp_path_factory.mktemp("export_grad")
    images = _images()
    np.save(root / "images.npy", images)
    # the JAX Explainer's SmoothGrad draws, keyed per word position (T = 5)
    np.save(root / "jax_noise.npy", te.jax_smoothgrad_noise(5, (8, 8, 3), 8).numpy())
    models = {}
    for model in ("adaptiveattention", *OTHER_MODELS):
        jcap = j_build(model, JConfig(drop_rate=0.0, **worker.SMALL), worker.VOCAB)
        pj = jcap.init_params(jax.random.PRNGKey(3))
        pt = params_from_jax(pj, "cpu")
        save_params_npz(str(root / f"{model}.npz"), pt)
        models[model] = (jcap, pj, t_build(model, TConfig(**worker.SMALL), worker.VOCAB), pt)
    jobs = []
    for model, method in CASES:
        name = _name(model, method)
        case = {"cli": True} if model == "cli" else {
            "model": model, "method": method, "params": str(root / f"{model}.npz"),
            "images": str(root / "images.npy")}
        if method == "smoothgrad":
            case.update(jax_noise=str(root / "jax_noise.npy"), isolation=True)
        with open(root / f"{name}.json", "w") as f:
            json.dump(case, f)
        jobs.append((name, str(root / f"{name}.json"), str(root / name)))
    out = {}
    with ThreadPoolExecutor(WORKERS) as pool:
        futures = {name: pool.submit(_run, path, d) for name, path, d in jobs}
        live = {}
        for model, method in CASES:
            if model != "cli":
                _, _, tcap, pt = models[model]
                ex = Explainer(tcap, pt, PP(), method, beam_size=2, word_buckets=(2,),
                               batch_size=worker.BATCH, device="cpu")
                live[_name(model, method)] = ex.analyze_batch(images)
        jcap, pj = models["adaptiveattention"][:2]
        jax_out = {}
        for method in JAX_METHODS:
            art = str(root / f"jax-{method}")
            j_export(jcap, pj, PP(), art, batch_size=worker.BATCH, beam_size=2, method=method,
                     word_buckets=(2,))
            jax_out[method] = JExported(art).explain(images)
        for name, d in ((n, d) for n, _, d in jobs):
            rc, log = futures[name].result()
            res, arrays = None, None
            if rc == 0:
                with open(os.path.join(d, "result.json")) as f:
                    res = json.load(f)
                with np.load(os.path.join(d, "result.npz")) as z:
                    arrays = dict(z)
            out[name] = dict(rc=rc, log=log, res=res, arrays=arrays, live=live.get(name))
    out["jax"] = jax_out
    return out


def _case(runs, name):
    r = runs[name]
    assert r["rc"] == 0, r["log"]
    return r


def _assert_matches_live(r):
    """Tokens exact, every array within RTOL of its scale."""
    got, live = r["res"]["explain"], r["live"]
    assert len(got) == len(live) == worker.BATCH
    for b, (g, w) in enumerate(zip(got, live)):
        assert g["caption"] == w.caption and g["words"] == w.words
        np.testing.assert_array_equal(g["tokens"], w.tokens_1based)
        for name in FIELDS:
            a = r["arrays"][f"{name}_{b}"]
            assert a.shape == getattr(w, name).shape, name
            assert np.isfinite(a).all(), name
            assert _rel(a, getattr(w, name)) <= RTOL, (name, _rel(a, getattr(w, name)))


@pytest.mark.parametrize("method", GRADIENT_METHODS)
def test_exported_gradient_explain_matches_live(runs, method):
    r = _case(runs, _name("adaptiveattention", method))
    _assert_matches_live(r)
    maps = [r["arrays"][f"relevance_maps_{b}"] for b in range(worker.BATCH)]
    assert sum(np.abs(m).sum() for m in maps) > 0


@pytest.mark.parametrize("model", sorted(OTHER_MODELS))
def test_exported_gridtd_and_aoa_match_live(runs, model):
    """grid-TD's two LSTMs a step; AOA's decoder gradient, autograd through
    ``lrpic::lstm_gates`` and its registered backward inside the trace."""
    _assert_matches_live(_case(runs, _name(model, OTHER_MODELS[model])))


@pytest.mark.parametrize("method", JAX_METHODS)
def test_exported_explain_matches_jax_export(runs, method):
    """The port's exported explain against the JAX package's exported
    explain on the same params and images: tokens equal, every array within
    MAP_RTOL of its scale (SmoothGrad on the JAX draws)."""
    r = _case(runs, _name("adaptiveattention", method))
    prefix, got = ("jax_", r["res"]["jax_explain"]) if method == "smoothgrad" else (
        "", r["res"]["explain"])
    ref = runs["jax"][method]
    assert len(got) == len(ref) == worker.BATCH
    for b, (g, w) in enumerate(zip(got, ref)):
        assert g["caption"] == w["caption"] and g["words"] == w["words"]
        np.testing.assert_array_equal(g["tokens"], w["tokens_1based"])
        for name in FIELDS:
            a, e = r["arrays"][f"{prefix}{name}_{b}"], np.asarray(w[name])
            assert a.shape == e.shape, name
            assert _rel(a, e) <= MAP_RTOL, (name, _rel(a, e))


@pytest.mark.parametrize("name", [_name(m, x) for m, x in CASES if m != "cli"])
def test_every_program_calls_k2_and_meta_keeps_the_jax_keys(runs, name):
    """The decode and each bucket's program reach K2 as ``lrpic::lstm_gates``
    (export_serving refuses a program without it); meta.json has the JAX
    artifact's keys, the method and the buckets (2, T)."""
    r = _case(runs, name)
    programs = r["res"]["programs"]
    assert sorted(programs) == ["2", "5", "None"]
    for w, p in programs.items():
        assert K2 in p["targets"], w
    meta = r["res"]["meta"]
    assert set(meta) == META_KEYS
    assert meta["method"] == name.split("-", 1)[1] and meta["buckets"] == [2, 5]


def test_smoothgrad_noise_is_an_input_not_a_constant(runs):
    """No constant of a SmoothGrad program has the noise's shape (rows,
    samples, H, W, 3); the loader's draws reach the maps: other draws give
    other maps, and the other arrays do not move."""
    r = _case(runs, _name("adaptiveattention", "smoothgrad"))
    for w in ("2", "5"):
        shapes = r["res"]["programs"][w]["constants"]
        assert not [s for s in shapes if len(s) == 5 and s[1:] == [8, 8, 8, 3]], shapes
    a = r["arrays"]
    assert any(_rel(a[f"relevance_maps_{b}"], a[f"jax_relevance_maps_{b}"]) > 1e-3
               for b in range(worker.BATCH))
    for b in range(worker.BATCH):
        np.testing.assert_array_equal(a[f"feat_relevance_{b}"], a[f"jax_feat_relevance_{b}"])


def test_loading_a_smoothgrad_artifact_imports_no_model_code(runs):
    """A fresh process loads the SmoothGrad artifact (drawing its noise from
    ``ops/noise.py``) and explains, with no models, explain, config or data
    module of the port imported."""
    iso = _case(runs, _name("adaptiveattention", "smoothgrad"))["res"]["isolation"]
    assert iso["rc"] == 0, iso["output"]


def test_cli_export_serving_and_serve_a_gradient_artifact(runs):
    """``export-serving --with-explain --method guided_gradcam`` writes the
    artifact; ``serve --exported`` answers /explain with the artifact's own
    explanation (float16 payload)."""
    r = _case(runs, "cli")
    meta = r["res"]["meta"]
    assert set(meta) == META_KEYS and meta["method"] == "guided_gradcam"
    assert r["res"]["server_stopped"]
    assert r["res"]["caption"] == r["res"]["direct_caption"]
    np.testing.assert_array_equal(r["arrays"]["maps"],
                                  r["arrays"]["direct_maps"].astype(np.float16))


def test_wrappers_route_to_the_custom_ops_while_make_fx_traces():
    """Under a ``make_fx`` trace (real or fake tensors) K2's wrapper records
    ``lrpic::lstm_gates``, whose ctypes launch the trace could not see;
    outside one it takes the direct route."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from lrp_imagecaptioning_torch.ops import kernels

    gen = torch.Generator().manual_seed(0)
    args = (torch.randn(2, 16, generator=gen), torch.randn(2, 16, generator=gen),
            torch.randn(16, generator=gen), torch.randn(2, 4, generator=gen))
    for mode in ("real", "fake"):
        gm = make_fx(kernels.lstm_gates, tracing_mode=mode)(*args)
        assert K2 in {str(n.target) for n in gm.graph.nodes}, mode
    for a, e in zip(gm(*args), kernels.lstm_gates_plain(*args)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


def test_lstm_gates_op_backward_is_the_plain_versions_gradient():
    """``lrpic::lstm_gates``' registered backward (``lstm_gates_vjp``) against
    autograd through the plain version, every input and cotangent."""
    from lrp_imagecaptioning_torch.ops import kernels

    gen = torch.Generator().manual_seed(1)
    ins = [torch.randn(3, 16, generator=gen) * 2, torch.randn(3, 16, generator=gen) * 2,
           torch.randn(16, generator=gen), torch.randn(3, 4, generator=gen)]
    ins = [t.requires_grad_() for t in ins]
    outs, ref = torch.ops.lrpic.lstm_gates(*ins), kernels.lstm_gates_plain(*ins)
    cot = [torch.randn(o.shape, generator=gen) for o in outs]
    for got, want in zip(torch.autograd.grad(outs, ins, cot), torch.autograd.grad(ref, ins, cot)):
        assert _rel(got.numpy(), want.numpy()) <= RTOL


def test_views_to_reshapes_refuses_in_place_ops():
    """A traced view that becomes a reshape may copy, so a graph that writes
    in place is refused rather than exported with a broken alias."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from lrp_imagecaptioning_torch.infer.export import _views_to_reshapes

    def pure(x):
        return x.view(6) * 2

    def in_place(x):
        y = x.view(6)
        x.add_(1)
        return y * 2

    x = torch.arange(6.0).reshape(2, 3)
    gm = _views_to_reshapes(make_fx(pure)(x))
    targets = {str(n.target) for n in gm.graph.nodes}
    assert "aten.reshape.default" in targets and "aten.view.default" not in targets
    torch.testing.assert_close(gm(x), pure(x))
    with pytest.raises(RuntimeError, match="in place"):
        _views_to_reshapes(make_fx(in_place)(x.clone()))
