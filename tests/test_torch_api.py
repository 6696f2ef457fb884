"""The port's public API against the JAX package's, read from the JAX
package's source with ``ast`` (no JAX module is imported here).

For every module of the JAX package (one case each):

* every public name (a top-level def, class or assignment not starting
  with ``_``) exists in the port's module of the same path;
* every shared function, class and public method takes the JAX package's
  parameter names in the JAX package's positional order, with its literal
  defaults; the port's own additions (``device=``, ``masks=``, ...) are
  keyword-only and have defaults; dataclass and NamedTuple fields come in
  the same order.

Every name a JAX ``__init__.py`` exports (its imports, the top level's
``_LAZY`` map, ``infer``'s lazy gRPC names) is reachable from the port's
package of the same path, in a fresh interpreter.

What stays different is ``DEPARTURES`` below, each entry with its reason;
``test_departure_fails_loudly`` calls each one the JAX way and requires the
port to raise.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "lrp_imagecaptioning_tpu"
J, T = "lrp_imagecaptioning_tpu", "lrp_imagecaptioning_torch"

# JAX's random keys: the port takes a torch.Generator (or an int seed, or
# ready masks / noise) at the same position, under its own name
RNG_NAMES = {"key", "rng_key", "dropout_rng", "split_rng"}

# (JAX module, qualified name) -> why the signature differs; the test below
# calls each the JAX way
DEPARTURES = {
    # the word-batched decoder explanation: all words of a caption in one
    # backward, (words_0based (B, W), positions (B, W)) for JAX's one word
    # (t, word_0based, T)
    ("explain/decoder_lrp.py", "explain_word_adaptive"): "word-batched (words_0based, positions)",
    ("explain/decoder_lrp.py", "explain_word_gridtd"): "word-batched (words_0based, positions)",
    ("explain/decoder_grad.py", "grad_word_adaptive"): "word-batched (words_0based, positions)",
    ("explain/decoder_grad.py", "grad_word_gridtd"): "word-batched (words_0based, positions)",
    ("explain/aoa_backward.py", "explain_word_aoa"): "word-batched (words_0based, positions)",
    ("explain/aoa_backward.py", "grad_word_aoa"): "word-batched (words_0based, positions)",
    # input_nonneg is keyword-only: a positional 11th argument raises
    ("ops/lrp_conv.py", "lrp_conv_alpha_beta"): "input_nonneg keyword-only",
}
# JAX modules with no counterpart: the Pallas kernels are CUDA kernels in
# ops/kernels.py (csrc/), so importing these names raises ImportError
PALLAS_MODULES = ("ops/pallas_kernels.py", "ops/pallas_conv_lrp.py")


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _literal(node):
    try:
        return ("lit", ast.literal_eval(node))
    except (ValueError, SyntaxError, TypeError):
        return ("expr", ast.unparse(node))


def _ast_sig(fn: ast.FunctionDef, drop_first: bool) -> dict:
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    defaults = dict(zip(pos[len(pos) - len(a.defaults):], map(_literal, a.defaults)))
    defaults.update({x.arg: _literal(d) for x, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None})
    return {"pos": pos[1:] if drop_first else pos, "kw": [x.arg for x in a.kwonlyargs],
            "defaults": defaults, "var": a.vararg is not None, "varkw": a.kwarg is not None}


def _decorators(node) -> set[str]:
    return {ast.unparse(d).split("(")[0].split(".")[-1] for d in node.decorator_list}


def _fields(classes: dict, node: ast.ClassDef) -> list[str]:
    """A dataclass's fields with those of its bases in the same module."""
    out = []
    for b in node.bases:
        if isinstance(b, ast.Name) and b.id in classes:
            out = _fields(classes, classes[b.id])
    for s in node.body:
        if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name) \
                and s.target.id not in out:
            out.append(s.target.id)
    return out


def _jax_public(rel: str) -> dict:
    """name -> ('def', sig) | ('class', {method: sig}, fields) | ('var',)."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    out = {}
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and not n.name.startswith("_"):
            out[n.name] = ("def", _ast_sig(n, False))
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            methods = {}
            for m in n.body:
                if isinstance(m, ast.FunctionDef) and (not m.name.startswith("_")
                                                       or m.name in ("__init__", "__call__")):
                    deco = _decorators(m)
                    if "property" in deco or "setter" in deco:
                        continue
                    methods[m.name] = _ast_sig(m, "staticmethod" not in deco)
            dc = "dataclass" in _decorators(n)
            nt = any(ast.unparse(b).endswith("NamedTuple") for b in n.bases)
            out[n.name] = ("class", methods, _fields(classes, n) if dc or nt else None)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[t.id] = ("var",)
    return out


def _port_sig(obj, drop_first: bool) -> dict:
    params = list(inspect.signature(obj).parameters.values())
    if drop_first:
        params = params[1:]
    P = inspect.Parameter
    return {"pos": [p.name for p in params if p.kind in (P.POSITIONAL_ONLY,
                                                        P.POSITIONAL_OR_KEYWORD)],
            "kw": [p.name for p in params if p.kind == P.KEYWORD_ONLY],
            "defaults": {p.name: p.default for p in params if p.default is not P.empty},
            "var": any(p.kind == P.VAR_POSITIONAL for p in params),
            "varkw": any(p.kind == P.VAR_KEYWORD for p in params)}


def _compare(js: dict, ts: dict, where: str, departure: bool) -> list[str]:
    """Every difference of ``ts`` (the port's) from ``js`` (the JAX package's)."""
    bad = []
    jp, tp = js["pos"], ts["pos"]
    if not departure:
        same = len(jp) == len(tp) and all(
            a == b or a in RNG_NAMES for a, b in zip(jp, tp))
        if not same and not (js["var"] and ts["var"] and tp == jp[:len(tp)]):
            bad.append(f"{where}: positional {tp}, JAX {jp}")
        if js["var"] != ts["var"] or (js["varkw"] and not ts["varkw"]):
            bad.append(f"{where}: *args/**kwargs differ")
    accepted = set(tp) | set(ts["kw"])
    for k in js["kw"] + ([] if departure else jp):
        if k not in accepted and k not in RNG_NAMES and not ts["varkw"]:
            bad.append(f"{where}: no parameter {k!r}")
    for k, (kind, v) in js["defaults"].items():
        if k not in accepted or k in RNG_NAMES:
            continue
        if k not in ts["defaults"]:
            bad.append(f"{where}: {k!r} has no default (JAX {v})")
        elif kind == "lit" and not _same_default(ts["defaults"][k], v):
            bad.append(f"{where}: {k!r} defaults to {ts['defaults'][k]!r}, JAX {v!r}")
    for k in set(tp) - set(jp):
        if not departure and k not in ("self",) and tp.index(k) >= len(jp):
            bad.append(f"{where}: the port's {k!r} is positional")
    for k in ts["kw"]:
        if k not in js["kw"] and k not in jp and k not in ts["defaults"]:
            bad.append(f"{where}: the port's keyword {k!r} has no default")
    return bad


def _same_default(a, b) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return list(a) == list(b)
    return type(a) is type(b) and a == b or (
        isinstance(a, (int, float)) and isinstance(b, (int, float))
        and not isinstance(a, bool) and not isinstance(b, bool) and a == b)


def _port_module(rel: str):
    name = T + "." + rel[:-3].replace(os.sep, ".")
    return importlib.import_module(name[:-len(".__init__")] if name.endswith(".__init__")
                                   else name)


@pytest.mark.parametrize("rel", [r for r in _jax_modules() if r not in PALLAS_MODULES
                                 and not r.endswith("__init__.py")])
def test_module_names_and_signatures_follow_jax(rel):
    mod = _port_module(rel)
    bad = []
    for name, info in _jax_public(rel).items():
        if not hasattr(mod, name):
            bad.append(f"{rel}: no {name!r}")
            continue
        obj = getattr(mod, name)
        departure = (rel, name) in DEPARTURES
        if info[0] == "def":
            if callable(obj):
                bad += _compare(info[1], _port_sig(obj, False), f"{rel}::{name}", departure)
            else:
                bad.append(f"{rel}::{name} is not callable")
        elif info[0] == "class":
            _, methods, fields = info
            if not inspect.isclass(obj):
                bad.append(f"{rel}::{name} is not a class")
                continue
            for m, js in methods.items():
                static = inspect.getattr_static(obj, m, None)
                if static is None:
                    bad.append(f"{rel}::{name}.{m} missing")
                    continue
                fn = static.__func__ if isinstance(static, (staticmethod, classmethod)) else static
                where = f"{rel}::{name}.{m}"
                bad += _compare(js, _port_sig(fn, not isinstance(static, staticmethod)), where,
                                (rel, f"{name}.{m}") in DEPARTURES)
            if fields is not None:
                got = ([f.name for f in dataclasses.fields(obj)] if dataclasses.is_dataclass(obj)
                       else list(getattr(obj, "_fields", ())))
                if got[:len(fields)] != fields:
                    bad.append(f"{rel}::{name} fields {got}, JAX {fields}")
    assert not bad, "\n".join(bad)


def _jax_exports(rel: str) -> list[str]:
    """Every name a JAX ``__init__.py`` exports: its relative imports, the
    ``_LAZY`` map's keys, the names its ``__getattr__`` serves."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    names = []
    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.level == 1:
            names += [a.asname or a.name for a in n.names]
        elif isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "_LAZY"
                                               for t in n.targets):
            names += [k.value for k in n.value.keys]
        elif isinstance(n, ast.FunctionDef) and n.name == "__getattr__":
            names += [c.value for c in ast.walk(n) if isinstance(c, ast.Constant)
                      and isinstance(c.value, str) and c.value.startswith("Caption")]
    return [x for x in names if not x.startswith("_")]


@pytest.mark.parametrize("rel", [r for r in _jax_modules() if r.endswith("__init__.py")])
def test_package_exports_follow_jax_in_a_fresh_process(rel):
    pkg = (T + "." + os.path.dirname(rel).replace(os.sep, ".")).rstrip(".")
    names = _jax_exports(rel)
    assert names or rel == "infer/proto/__init__.py"
    code = ("import importlib, sys\n"
            f"pkg = importlib.import_module({pkg!r})\n"
            f"missing = [n for n in {names!r} if not hasattr(pkg, n)]\n"
            f"listed = [n for n in {names!r} if n not in dir(pkg)]\n"
            "print(missing, listed)\n"
            "sys.exit(1 if missing or listed else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr


def test_importing_the_package_loads_no_submodule():
    """The exports are lazy: importing the package and its subpackages loads
    no module of theirs (no model code, no grpcio, h5py or matplotlib) until
    a name is used."""
    code = ("import sys\n"
            "import lrp_imagecaptioning_torch.explain, lrp_imagecaptioning_torch.train\n"
            "import lrp_imagecaptioning_torch.infer, lrp_imagecaptioning_torch.models\n"
            "import lrp_imagecaptioning_torch.data, lrp_imagecaptioning_torch.evalx\n"
            "import lrp_imagecaptioning_torch.ops, lrp_imagecaptioning_torch.utils\n"
            "pkgs = {'explain', 'train', 'infer', 'models', 'data', 'evalx', 'ops', 'utils'}\n"
            "mods = sorted(m for m in sys.modules if m.startswith('lrp_imagecaptioning_torch.')"
            " and m.split('.', 1)[1] not in pkgs)\n"
            "mods += [m for m in ('grpc', 'h5py', 'matplotlib') if m in sys.modules]\n"
            "print(mods)\n"
            "sys.exit(1 if mods else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr


# -- the departures, each called the JAX way ---------------------------------------


def _jax_key():
    jax = pytest.importorskip("jax")
    return jax.random.PRNGKey(0)


def _small_cfg():
    from lrp_imagecaptioning_torch.config import FlickrConfig

    return FlickrConfig(embedding_dim=8, hidden_dim=8, layer_name="block1_conv1",
                        img_feature_length=4, img_feature_dim=64, sentence_length=3)


def _rng_calls():
    """The JAX-way calls of the functions that take a torch.Generator (or an
    int seed) where the JAX package takes a PRNG key, the key passed at the
    key's position."""
    from lrp_imagecaptioning_torch.explain import analyzers, cnn_gradient
    from lrp_imagecaptioning_torch.models import (adaptive, aoa, captioner, cells, gridtd,
                                                  inception, resnet, vgg, word_vectors)
    from lrp_imagecaptioning_torch.train import step

    key, cfg = _jax_key(), _small_cfg()
    cap = captioner.build_captioner("adaptiveattention", cfg, 5)
    image, seed = torch.zeros(1, 2, 2, 3), torch.zeros(1, 2, 2, 64)
    feats, caps = torch.zeros(1, 4, 64), torch.zeros(1, 2, dtype=torch.long)
    p = {"vgg": vgg.init_vgg_params(torch.Generator(), "vgg16", "block1_conv1"),
         "decoder": adaptive.init_params(torch.Generator(), 5, cfg)}
    return {
        "models/vgg.py::init_vgg_params": lambda: vgg.init_vgg_params(key, "vgg16"),
        "models/resnet.py::init_resnet50_params": lambda: resnet.init_resnet50_params(key),
        "models/inception.py::init_inception_v3_params":
            lambda: inception.init_inception_v3_params(key),
        "models/cells.py::lstm_init": lambda: cells.lstm_init(key, 4, 4),
        "models/cells.py::lstm_dropout_masks": lambda: cells.lstm_dropout_masks(key, 4, 4, 0.5),
        "models/cells.py::dense_init": lambda: cells.dense_init(key, 4, 4),
        "models/cells.py::attn_weight_init": lambda: cells.attn_weight_init(key, (4, 4)),
        "models/adaptive.py::init_params": lambda: adaptive.init_params(key, 5, cfg),
        "models/gridtd.py::init_params": lambda: gridtd.init_params(key, 5, cfg),
        "models/aoa.py::init_params": lambda: aoa.init_params(key, 5, cfg),
        "models/adaptive.py::forward_train":
            lambda: adaptive.forward_train(p["decoder"], feats, caps, cfg, key, 0.5),
        "models/gridtd.py::forward_train":
            lambda: gridtd.forward_train(gridtd.init_params(torch.Generator(), 5, cfg), feats,
                                         caps, cfg, key, 0.5),
        "models/aoa.py::forward_train":
            lambda: aoa.forward_train(aoa.init_params(torch.Generator(), 5, cfg), feats, caps,
                                      cfg, key, 0.5),
        "models/captioner.py::Captioner.init_params": lambda: cap.init_params(key),
        "models/captioner.py::Captioner.forward_train":
            lambda: cap.forward_train(p, image, caps, key),
        "models/captioner.py::Captioner.loss":
            lambda: cap.loss(p, image, caps, torch.zeros(1, 2, 5), key),
        "models/word_vectors.py::init_embedding":
            lambda: word_vectors.init_embedding(key, ["a"], 4),
        "models/word_vectors.py::WordVector.vectorize_words":
            lambda: word_vectors.WordVector(["a"], None, None, 4).vectorize_words(key),
        "explain/cnn_gradient.py::vgg_smoothgrad":
            lambda: cnn_gradient.vgg_smoothgrad(p["vgg"], image, seed, key, "vgg16",
                                                "block1_conv1", 2),
        "explain/analyzers.py::gaussian_smoother":
            lambda: analyzers.gaussian_smoother(lambda x, s: x, image, seed, key, 1.0, 2),
        "train/step.py::run_stepped_steps":
            lambda: step.run_stepped_steps(iter(()), 0, 1, None, lambda n: [key] * n, None,
                                           None, {}, {}, None),
    }


def _rng_sites() -> list[str]:
    """Every JAX function or method with a parameter in RNG_NAMES."""
    sites = []
    for rel in _jax_modules():
        if rel in PALLAS_MODULES or rel.endswith("__init__.py"):
            continue
        for name, info in _jax_public(rel).items():
            sigs = {name: info[1]} if info[0] == "def" else (
                {f"{name}.{m}": s for m, s in info[1].items()} if info[0] == "class" else {})
            sites += [f"{rel}::{q}" for q, s in sigs.items()
                      if RNG_NAMES & set(s["pos"] + s["kw"])]
    return sorted(sites)


def test_every_rng_departure_is_called_the_jax_way():
    """The table of RNG calls below covers every JAX parameter in RNG_NAMES."""
    calls = _rng_calls()
    assert sorted(calls) == _rng_sites()


@pytest.mark.parametrize("site", _rng_sites())
def test_rng_departure_fails_loudly(site):
    """A JAX PRNG key where the port takes a torch.Generator or a seed raises."""
    call = _rng_calls()[site]
    with pytest.raises((TypeError, ValueError)):
        call()


@pytest.mark.parametrize("where", sorted(f"{m}::{q}" for m, q in DEPARTURES))
def test_departure_fails_loudly(where):
    """The JAX positional call of each entry of DEPARTURES raises."""
    rel, qual = where.split("::")
    fn = getattr(_port_module(rel), qual)
    if qual == "lrp_conv_alpha_beta":
        x = torch.ones(1, 4, 4, 2)
        args = (torch.ones(1, 4, 4, 3), x, torch.ones(3, 3, 2, 3), None, 1.0, 0.0, 1, "SAME",
                1e-7, None, True)
    else:
        args = (None, None, None, 3, 1, 5)     # (params, consts, caches, t, word_0based, T)
    with pytest.raises(TypeError):
        fn(*args)


@pytest.mark.parametrize("rel", PALLAS_MODULES)
def test_pallas_module_is_not_ported_under_its_name(rel):
    """The Pallas kernels' modules: their CUDA counterparts are ops/kernels.py."""
    with pytest.raises(ImportError):
        _port_module(rel)


def test_orbax_checkpoint_directory_raises(tmp_path):
    """restore_checkpoint on an orbax checkpoint (a directory) raises and
    names the flat npz that both packages read."""
    from lrp_imagecaptioning_torch.train.checkpoint import restore_checkpoint

    with pytest.raises(ValueError, match="save_params_npz"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(1)})


def test_cli_jax_cache_flag_is_refused():
    """``--jax-cache`` (the JAX compile cache) is not an option of the port's CLI."""
    from lrp_imagecaptioning_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--jax-cache", "cache", "train"])
    assert e.value.code == 2


def test_stale_device_positional_call_raises():
    """``device`` is keyword-only: the port's old ``init_params(0, "cpu")``
    raises instead of building a vocabulary of "c", "p", "u"."""
    cap = __import__("lrp_imagecaptioning_torch.models.captioner",
                     fromlist=["build_captioner"]).build_captioner("adaptiveattention",
                                                                   _small_cfg(), 5)
    with pytest.raises(TypeError, match="vocab_words"):
        cap.init_params(0, "cpu")
    assert cap.init_params(0, device="cpu")["vgg"]["block1_conv1"]["kernel"].device.type == "cpu"


@pytest.mark.parametrize("call", ["vgg_apply", "vgg_layers", "init_vgg_params", "preset_a"])
def test_swapped_arch_and_until_raise(call):
    """A call with ``until`` where ``arch`` goes (the port's old order)
    raises ``ValueError`` rather than run another network."""
    from lrp_imagecaptioning_torch.explain import cnn_lrp
    from lrp_imagecaptioning_torch.models import vgg

    p = vgg.init_vgg_params(torch.Generator(), "vgg16", "block1_conv2")
    x = torch.zeros(1, 4, 4, 3)
    fns = {"vgg_apply": lambda: vgg.vgg_apply(p, x, "block1_conv2", "vgg16"),
           "vgg_layers": lambda: vgg.vgg_layers("block1_conv2"),
           "init_vgg_params": lambda: vgg.init_vgg_params(torch.Generator(), "block1_conv2"),
           "preset_a": lambda: cnn_lrp.vgg_lrp_preset_a(p, x, torch.zeros(1, 4, 4, 64),
                                                        "block1_conv2")}
    with pytest.raises(ValueError, match="arch"):
        fns[call]()
    with pytest.raises(ValueError, match="not in vgg19"):
        vgg.vgg_layers("vgg19", "block6_conv1")


def test_api_doc_names_every_departure():
    """docs/API_torch.md lists each departure kind."""
    doc = (ROOT / "docs" / "API_torch.md").read_text()
    for word in ("torch.Generator", "words_0based", "orbax", "pallas_kernels", "--jax-cache",
                 "input_nonneg", "device="):
        assert word in doc, word
