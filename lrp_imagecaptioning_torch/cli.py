"""Command line of the port, the JAX package's ``cli.py`` subcommands:

    python -m lrp_imagecaptioning_torch.cli train         --dataset flickr30k --model gridTD ...
    python -m lrp_imagecaptioning_torch.cli finetune-lrp  --weights ckpt.npz ...
    python -m lrp_imagecaptioning_torch.cli evaluate      --weights ckpt.npz --beam-size 3 ...
    python -m lrp_imagecaptioning_torch.cli explain       --weights ckpt.npz --image img.jpg --method lrp
    python -m lrp_imagecaptioning_torch.cli evaluate-bbox --weights ckpt.npz --entities-json F.json
    python -m lrp_imagecaptioning_torch.cli analyze-words --weights ckpt.npz --predictions P.yaml --roc-auc
    python -m lrp_imagecaptioning_torch.cli parity        --h5 ckpt.hdf5 --image img.png --out DIR
    python -m lrp_imagecaptioning_torch.cli serve         --weights ckpt.npz --with-explain --port 8000
    python -m lrp_imagecaptioning_torch.cli export-serving --weights ckpt.npz --with-explain --out DIR
    python -m lrp_imagecaptioning_torch.cli serve         --exported DIR --with-explain

``--model`` is adaptiveattention, gridTD or aoa; the encoder is the config's
(``--set img_encoder=vgg16|vgg19|resnet50|resnet101|inception_v3`` with its
``layer_name``, ``img_feature_length`` and ``img_feature_dim``, as the JAX
CLI takes them), and the images are read at the encoder's size (299x299
for inception_v3, else 224x224) unless ``--set image_size=`` says otherwise.
Every subcommand takes ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions) and ``--profile DIR`` writes a ``torch.profiler``
trace of the whole command. ``--weights`` reads the port's npz checkpoints,
the JAX package's flat params npz (its ``save_params_npz``) and reference
Keras .h5/.hdf5 files. ``parity`` reads and writes the JAX command's
``parity-expected.npz`` (keys ``tokens_1based``, ``relevance_maps``,
``attentions``), so one recording checks both packages. ``serve`` runs the
HTTP (or ``--transport grpc``) front-end over a warmed ``CaptionService``
with its micro-batching queue, or over an ``export-serving`` artifact
(``--exported DIR``: no model, config or tokenizer code in the process).
``train --num-devices N`` trains data-parallel over N devices and ``serve
--mesh N`` serves over them (``--shard-words``: one image's words split
over the mesh); with ``--device cpu`` the mesh is N slots on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from types import SimpleNamespace

import numpy as np

# explain.engine.METHODS, as a literal so that `--help` imports no torch
# (tests hold the two equal)
_METHOD_CHOICES = ("lrp", "gradient", "input_times_gradient", "guided_gradcam",
                   "integrated_gradients", "smoothgrad", "guided_backprop",
                   "deconvnet", "deep_taylor", "deep_lift")


def _coerce_config_value(cfg, key: str, raw: str):
    """Parse a --set key=value string against the config field's type."""
    fields = {f.name: f for f in dataclasses.fields(type(cfg))}
    if key not in fields:
        raise SystemExit(f"--set: unknown config field {key!r}")
    current = getattr(cfg, key)
    if raw.lower() in ("none", "null"):
        return None
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    ann = str(fields[key].type)
    if isinstance(current, tuple) or (current is None and "tuple" in ann):
        vals = tuple(int(x) for x in raw.split(","))
        return vals * 2 if len(vals) == 1 else vals   # "64" -> (64, 64)
    if current is None and "int" in ann:
        return int(raw)
    if current is None and "float" in ann:
        return float(raw)
    return raw


def _build_config(args):
    """The dataset's config with the common flags and the --set overrides,
    without reading the dataset's files."""
    from .config import COCO2014Config, COCOConfig, FlickrConfig

    cfg = {"flickr30k": FlickrConfig, "coco": COCOConfig, "coco2014": COCO2014Config,
           "synthetic": FlickrConfig}[getattr(args, "dataset", "flickr30k")]()
    overrides = {}
    for field in ("batch_size", "learning_rate", "epochs"):
        v = getattr(args, field, None)
        if v is not None:
            overrides[field] = v
    if getattr(args, "dataset_root", None):
        overrides["dataset_root"] = args.dataset_root
    if getattr(args, "bf16", False):
        overrides["compute_dtype"] = "bfloat16"
    for kv in args.config_set or ():
        key, _, raw = kv.partition("=")
        overrides[key] = _coerce_config_value(cfg, key, raw)
    return cfg.replace(**overrides) if overrides else cfg


def _build_dataset(args):
    from .data import datasets

    cfg = _build_config(args)
    if args.dataset == "synthetic":
        return cfg, datasets.SyntheticDataset(cfg)
    ds_cls = {"flickr30k": datasets.Flickr30kDataset, "coco": datasets.COCODataset,
              "coco2014": datasets.COCODatasetKarpathy}[args.dataset]
    return cfg, ds_cls(cfg)


def _add_common(p):
    p.add_argument("--dataset", default="flickr30k",
                   choices=["flickr30k", "coco", "coco2014", "synthetic"])
    p.add_argument("--model", dest="model_type", default="adaptiveattention",
                   choices=["adaptiveattention", "gridTD", "aoa"])
    p.add_argument("--weights", default=None, help=".npz (the port's checkpoint or the JAX "
                                                   "package's flat params) or reference .hdf5")
    p.add_argument("--batch-size", type=int, dest="batch_size", default=None)
    p.add_argument("--dataset-root", dest="dataset_root", default=None,
                   help="override the config's dataset_root path")
    p.add_argument("--set", dest="config_set", action="append", metavar="KEY=VALUE",
                   help="override any config field, e.g. --set hidden_dim=64 "
                        "(repeatable; values parsed by field type)")
    p.add_argument("--bf16", action="store_true",
                   help="encoder convolutions in bfloat16 (= --set compute_dtype=bfloat16)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _load_params(captioner, args):
    """--weights, else the captioner's random init from seed 0."""
    if not args.weights:
        return captioner.init_params(0, device=args.device)
    from .train.trainer import load_weights_file

    return load_weights_file(args.weights, captioner, args.device)[0]


def _mesh(n: int, device: str):
    """An N-slot data-parallel mesh: the first N cards, or N slots on the CPU
    when the caller asked for it."""
    from .parallel import make_mesh

    return make_mesh(n, devices=[device] * n if device == "cpu" else None)


def cmd_train(args):
    from .train.trainer import Trainer

    cfg, dataset = _build_dataset(args)
    mesh = _mesh(args.num_devices, args.device) if args.num_devices else None
    t = Trainer(args.model_type, cfg, dataset, label=args.label, mesh=mesh,
                steps_per_call=args.steps_per_call, device=args.device)
    if args.weights:
        t.load_weights(args.weights)
    if args.resume:
        t.resume_latest()
    t.run(epochs=args.epochs, time_limit=args.time_limit)


def cmd_finetune_lrp(args):
    from .data.provider import DatasetProvider
    from .models.captioner import build_captioner
    from .train.lrp_finetune import LRPFinetuner

    cfg, dataset = _build_dataset(args)
    provider = DatasetProvider(dataset, cfg)
    captioner = build_captioner(args.model_type, cfg, provider.vocab_size)
    tuner = LRPFinetuner(captioner, _load_params(captioner, args), provider, mode=args.lrp_mode,
                         learning_rate=args.learning_rate or 1e-6,
                         steps_per_call=args.steps_per_call,
                         max_explained_words=args.max_explained_words, device=args.device)
    # the reference drives 50 chunks x 10 iterations (train.py:696-716)
    for save_idx in range(args.start_chunk, args.chunks):
        m = tuner.run(save_idx, args.epoch_length, result_dir=args.out or "results/lrp-finetune")
        print(f"chunk {save_idx}: {m}")


def cmd_evaluate(args):
    from .data.provider import DatasetProvider
    from .evalx.metrics import BERT, SPICE, default_metrics
    from .infer.api import BasicInference, BeamSearchInference
    from .models.captioner import build_captioner

    cfg, dataset = _build_dataset(args)
    provider = DatasetProvider(dataset, cfg)
    captioner = build_captioner(args.model_type, cfg, provider.vocab_size)
    params = _load_params(captioner, args)
    cls = BeamSearchInference if args.beam_size > 1 else BasicInference
    kw = {"beam_size": args.beam_size} if args.beam_size > 1 else {}
    if args.spice_detailed:
        # the detailed SPICE in place of the plain one: the corpus is parsed once
        kw["metrics"] = [SPICE(detailed=True) if isinstance(m, SPICE) else m
                         for m in default_metrics()]
    inference = cls(captioner, params, provider, max_caption_length=cfg.sentence_length,
                    device=args.device, **kw)
    metrics, preds, refs = inference.evaluate_test_set(include_prediction=True)
    if args.bert_model:
        metrics.update(BERT(model_path=args.bert_model).calculate(preds, refs))
    print(metrics)
    if args.out:
        import yaml

        os.makedirs(args.out, exist_ok=True)
        for name, obj in [("metrics", metrics), ("predictions", preds), ("reference", refs)]:
            with open(os.path.join(args.out, f"test-{name}.yaml"), "w") as f:
                yaml.safe_dump(obj, f)


def cmd_explain(args):
    from .data.provider import DatasetProvider
    from .explain.drivers import explain_image_file, process_beam_search
    from .models.captioner import build_captioner

    cfg, dataset = _build_dataset(args)
    provider = DatasetProvider(dataset, cfg)
    captioner = build_captioner(args.model_type, cfg, provider.vocab_size)
    params = _load_params(captioner, args)
    out = args.out or ((args.weights or "model") + ".explanation")
    if args.image:
        ex = explain_image_file(captioner, params, provider.caption_preprocessor, args.image, out,
                                method=args.method, beam_size=args.beam_size, device=args.device)
        print(ex.caption)
    else:
        for ex in process_beam_search(captioner, params, provider, out, method=args.method,
                                      beam_size=args.beam_size, num_images=args.num_images,
                                      device=args.device):
            print(ex.caption)


def cmd_evaluate_bbox(args):
    """evaluate_bbox.py driver parity: bbox correctness over the test split."""
    from .data.categories import load_entities_json
    from .data.provider import DatasetProvider
    from .evalx.bbox import analyze_results, evaluate_dataset
    from .explain.engine import Explainer
    from .models.captioner import build_captioner

    cfg, dataset = _build_dataset(args)
    provider = DatasetProvider(dataset, cfg)
    captioner = build_captioner(args.model_type, cfg, provider.vocab_size)
    params = _load_params(captioner, args)
    explainer = Explainer(captioner, params, provider.caption_preprocessor, method=args.method,
                          beam_size=args.beam_size, device=args.device)
    category_dict = load_entities_json(args.entities_json)
    out_json = args.out or "bbox-correctness.json"
    results = evaluate_dataset(explainer, provider, category_dict, out_json,
                               negate=not args.positive, max_images=args.max_images)
    print(analyze_results(results, out_csv=out_json.replace(".json", ".csv")))


def cmd_analyze_words(args):
    """exaimin_word.py driver parity: frequent-object mAP and the ROC-AUCs."""
    import yaml

    from .data.provider import DatasetProvider
    from .evalx.words import (COCO_FREQUENT_OBJECT, FREQUENT_OBJECT, beta_roc_auc,
                              collect_word_stats, frequent_object_map, mean_roc_auc)
    from .explain.engine import Explainer
    from .models.captioner import build_captioner

    cfg, dataset = _build_dataset(args)
    with open(args.predictions) as f:
        raw = yaml.safe_load(f)
    id_to_pred = {k: (v[0]["caption"] if isinstance(v, list) else v) for k, v in raw.items()}
    id_to_refs = {d.img_filename: list(d.all_captions_txt) for d in dataset.test_set}
    cats = COCO_FREQUENT_OBJECT if args.dataset.startswith("coco") else FREQUENT_OBJECT
    print("frequent-object mAP:", frequent_object_map(id_to_pred, id_to_refs, cats))

    if args.roc_auc:
        # the provider (a vocabulary fit over every training caption) is
        # only needed for the Explainer
        provider = DatasetProvider(dataset, cfg)
        captioner = build_captioner(args.model_type, cfg, provider.vocab_size)
        params = _load_params(captioner, args)
        explainer = Explainer(captioner, params, provider.caption_preprocessor, method="lrp",
                              beam_size=args.beam_size, device=args.device)
        stats = collect_word_stats(explainer, provider, id_to_pred, cats,
                                   max_images=args.max_images)
        _, _, auc_b = beta_roc_auc(stats)
        _, _, auc_l = mean_roc_auc(stats, "lrp_mean")
        _, _, auc_a = mean_roc_auc(stats, "attention_mean")
        print(f"ROC-AUC beta={auc_b:.4f} lrp_mean={auc_l:.4f} attention_mean={auc_a:.4f}")


def parity_diff(got: dict, exp, tol: float) -> list:
    """Compare a freshly computed parity record against a stored one.

    Returns the failures (empty = parity OK) and prints one deviation line
    per array. A record with zero explained words (an immediate-EOS decode)
    compares by shape alone."""
    failures = []
    if not np.array_equal(got["tokens_1based"], exp["tokens_1based"]):
        failures.append(
            f"tokens differ: got {np.asarray(got['tokens_1based']).tolist()} "
            f"expected {np.asarray(exp['tokens_1based']).tolist()}")
    for key in ("relevance_maps", "attentions"):
        want = exp[key]
        if got[key].shape != want.shape:
            failures.append(f"{key} shape {got[key].shape} != {want.shape}")
            continue
        if want.size == 0:
            dev = 0.0
        else:
            scale = float(np.abs(want).max()) or 1.0
            dev = float(np.abs(got[key] - want).max()) / scale
        status = "ok" if dev <= tol else "FAIL"
        print(f"{key}: max dev {dev:.3e} of expectation scale (tol {tol:g}) {status}")
        if dev > tol:
            failures.append(f"{key} deviates {dev:.3e} > tol {tol:g}")
    return failures


def cmd_parity(args):
    """Load a reference Keras .hdf5 (dims inferred from it), caption and
    explain one image, then RECORD the outputs (--out DIR) or DIFF them
    against a recorded expectation (--expect DIR): token-exact captions,
    relevance and attention maps within --tol of the expectation's scale.
    Exits 1 on a mismatch."""
    from .data.images import ImagePreprocessor
    from .explain.engine import Explainer
    from .models.captioner import build_captioner
    from .models.weights_io import infer_h5_dims, load_reference_checkpoint_h5

    dims = infer_h5_dims(args.h5)
    cfg = _build_config(args).replace(embedding_dim=dims["embedding_dim"],
                                      hidden_dim=dims["hidden_dim"])
    vocab_size = dims["vocab_size"]
    if args.dataset_root:
        # the dataset's vocabulary decodes real words
        from .data.provider import DatasetProvider

        _, dataset = _build_dataset(args)
        pp = DatasetProvider(dataset, cfg).caption_preprocessor
    else:
        pp = SimpleNamespace(SOS_TOKEN="szeros", EOS_TOKEN="zeros",
                             SOS_TOKEN_LABEL_ENCODED=1, EOS_TOKEN_LABEL_ENCODED=2,
                             word_of={i: f"w{i}" for i in range(1, vocab_size + 1)})
        pp.word_of[1], pp.word_of[2] = "szeros", "zeros"

    captioner = build_captioner(args.model_type, cfg, vocab_size)
    params = load_reference_checkpoint_h5(args.h5, args.model_type, cfg.img_encoder,
                                          cfg.layer_name, device=args.device)
    ip = ImagePreprocessor(encoder=cfg.img_encoder, image_size=cfg.image_size)
    img = ip.preprocess_batch_paths([args.image])[0]

    ex = Explainer(captioner, params, pp, method=args.method, beam_size=args.beam_size,
                   max_len=cfg.sentence_length, device=args.device)
    e = ex.analyze(img)
    got = {"tokens_1based": np.asarray(e.tokens_1based),
           "relevance_maps": np.asarray(e.relevance_maps),
           "attentions": np.asarray(e.attentions)}
    print(f"caption: {e.caption}")

    if args.expect:
        exp = np.load(os.path.join(args.expect, "parity-expected.npz"))
        failures = parity_diff(got, exp, args.tol)
        if failures:
            raise SystemExit("PARITY FAIL:\n  " + "\n  ".join(failures))
        print("PARITY OK")
    else:
        out = args.out or (args.h5 + ".parity")
        os.makedirs(out, exist_ok=True)
        np.savez(os.path.join(out, "parity-expected.npz"), **got)
        with open(os.path.join(out, "caption.txt"), "w") as f:
            f.write(e.caption + "\n")
        print(f"recorded parity expectation in {out} (re-run with --expect {out} to diff)")


def cmd_export_serving(args):
    """Trace the decode (and, with --with-explain, the bucketed explain
    programs) into a torch.export serving artifact (infer/export.py)."""
    from .data.provider import DatasetProvider
    from .infer.export import export_serving
    from .models.captioner import build_captioner

    cfg, dataset = _build_dataset(args)
    provider = DatasetProvider(dataset, cfg)
    captioner = build_captioner(args.model_type, cfg, provider.vocab_size)
    params = _load_params(captioner, args)
    out = export_serving(captioner, params, provider.caption_preprocessor, args.out,
                         batch_size=args.batch_size or cfg.batch_size, beam_size=args.beam_size,
                         method=args.method if args.with_explain else None, device=args.device)
    print(f"exported serving artifact to {out}")


def _validate_exported(args) -> dict:
    """Fail at start-up, before the artifact is loaded, where the flags
    contradict what it was exported with; returns its meta.json."""
    import json

    with open(os.path.join(args.exported, "meta.json")) as f:
        meta = json.load(f)
    exported_method = meta.get("method")
    if args.with_explain and not exported_method:
        raise SystemExit("--with-explain: artifact was exported without explain programs "
                         "(re-export with --with-explain/--method)")
    if args.with_explain and args.method and args.method != exported_method:
        raise SystemExit(f"--method {args.method}: artifact was exported with method "
                         f"{exported_method!r}")
    for flag, val, default in (("--batch-size", args.batch_size, None),
                               ("--beam-size", args.beam_size, 3),
                               ("--shard-words", args.shard_words, False),
                               ("--split-buckets", args.split_buckets, False)):
        if val != default:
            print(f"warning: {flag} is fixed at export time; ignoring (artifact: batch "
                  f"{meta['batch_size']}, beam {meta['beam_size']})", flush=True)
    return meta


def cmd_serve(args):
    """A warmed CaptionService with its micro-batching queue behind the HTTP
    (or gRPC) front-end; with --exported DIR an ExportedService over a
    torch.export artifact instead."""
    import time

    import torch

    from .infer.http_server import CaptionHTTPServer

    if args.shard_words and args.mesh <= 1 and not args.exported:
        raise ValueError("--shard-words needs --mesh N > 1: shard_words=True requires a mesh")
    if args.exported:
        from .infer.export import ExportedService

        _validate_exported(args)
        # --mesh N: N params replicas, request chunks round-robined over them;
        # the flag is checked before the artifact loads, so that a fault of
        # the artifact is not blamed on it
        devices = None
        if args.mesh > 1:
            avail = (args.mesh if args.device == "cpu" else
                     torch.cuda.device_count() if torch.cuda.is_available() else 0)
            if args.mesh > avail:
                raise SystemExit(f"--mesh {args.mesh}: devices={args.mesh} but only {avail} "
                                 "available")
            devices = [args.device] * args.mesh if args.device == "cpu" else args.mesh
        print(f"loading exported artifact {args.exported}...", flush=True)
        svc = ExportedService(args.exported, devices=devices, device=args.device)
        print(f"warmed in {svc.stats.get('warmup_s')}s (batch {svc.meta['batch_size']}, "
              f"beam {svc.meta['beam_size']}, devices {svc.stats['devices']})", flush=True)
    else:
        from .data.provider import DatasetProvider
        from .infer.serving import CaptionService
        from .models.captioner import build_captioner

        cfg, dataset = _build_dataset(args)
        provider = DatasetProvider(dataset, cfg)
        captioner = build_captioner(args.model_type, cfg, provider.vocab_size)
        params = _load_params(captioner, args)
        serve_batch = args.batch_size or cfg.batch_size
        mesh = _mesh(args.mesh, args.device) if args.mesh > 1 else None
        svc = CaptionService(captioner, params, provider.caption_preprocessor,
                             batch_size=serve_batch, beam_size=args.beam_size, mesh=mesh,
                             shard_words=args.shard_words, split_buckets=args.split_buckets,
                             device=args.device)
        print(f"warming up (batch {serve_batch}, beam {args.beam_size}, "
              f"explain={args.with_explain})...", flush=True)
        svc.warmup(explain=args.with_explain, method=args.method or "lrp")
        svc.start_queue(linger_ms=args.linger_ms)
    if args.transport == "grpc":
        from .infer.grpc_server import CaptionGrpcServer

        server = CaptionGrpcServer(svc, host=args.host, port=args.port).start()
        print(f"serving gRPC on {args.host}:{server.port} "
              f"(/lrpic.CaptionService/{{Caption,Explain,Health,Stats}})", flush=True)
    else:
        server = CaptionHTTPServer(svc, host=args.host, port=args.port).start()
        print(f"serving on http://{args.host}:{server.port} "
              f"(POST /caption, /explain; GET /healthz, /stats)", flush=True)
    try:
        if args.serve_seconds:
            time.sleep(args.serve_seconds)
        else:  # pragma: no cover - interactive loop
            import threading

            threading.Event().wait()
    except KeyboardInterrupt:  # pragma: no cover - interactive loop
        pass
    finally:
        server.stop()
        if hasattr(svc, "stop_queue"):
            svc.stop_queue()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lrp_imagecaptioning_torch.cli")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the whole command to DIR/trace.json "
                         "(utils/profiling.py::trace)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a captioner (train.py main_attention parity)")
    _add_common(p)
    p.add_argument("--label", default="run")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--learning-rate", type=float, dest="learning_rate", default=None)
    p.add_argument("--time-limit", default=None, help="e.g. '12 hours'")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel mesh size (the first N cards; N CPU slots with "
                        "--device cpu)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per device dispatch (CUDA-graph replays over "
                        "stacked batches; amortizes dispatch latency)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("finetune-lrp", help="LRP-inference fine-tuning (train.py:519-673)")
    _add_common(p)
    p.add_argument("--lrp-mode", default="mean", choices=["mean", "pos_mean", "quantile"])
    p.add_argument("--learning-rate", type=float, dest="learning_rate", default=1e-6)
    p.add_argument("--chunks", type=int, default=50)
    p.add_argument("--start-chunk", type=int, default=0)
    p.add_argument("--epoch-length", type=int, default=10)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="finetune steps per device dispatch (CUDA-graph replays over "
                        "stacked batches; amortizes dispatch latency)")
    p.add_argument("--max-explained-words", type=int, default=None, dest="max_explained_words",
                   help="run the per-word LRP backward for at most this many non-stop pre-EOS "
                        "positions per sample (default: all positions)")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_finetune_lrp)

    p = sub.add_parser("evaluate", help="caption-metric evaluation (inference.py main)")
    p.add_argument("--bert-model", dest="bert_model", default=None,
                   help="local transformers model dir: also report BERTScore")
    p.add_argument("--spice-detailed", dest="spice_detailed", action="store_true",
                   help="also report the SPICE per-category breakdown")
    _add_common(p)
    p.add_argument("--beam-size", type=int, default=3)
    p.add_argument("--out", default=None, help="dir for test-{metrics,predictions,reference}.yaml")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("explain", help="word-by-word explanation (explain_image.py)")
    _add_common(p)
    p.add_argument("--method", default="lrp", choices=list(_METHOD_CHOICES))
    p.add_argument("--image", default=None, help="explain one image file")
    p.add_argument("--num-images", type=int, default=1)
    p.add_argument("--beam-size", type=int, default=3)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser("evaluate-bbox", help="bbox explanation correctness (evaluate_bbox.py)")
    _add_common(p)
    p.add_argument("--entities-json", required=True,
                   help="COCOvalEntities.json / Flickr30kEntities.json")
    p.add_argument("--method", default="lrp", choices=list(_METHOD_CHOICES))
    p.add_argument("--beam-size", type=int, default=3)
    p.add_argument("--positive", action="store_true",
                   help="score positive evidence (the reference negates)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_evaluate_bbox)

    p = sub.add_parser("analyze-words", help="frequent-object mAP + ROC-AUC (exaimin_word.py)")
    _add_common(p)
    p.add_argument("--predictions", required=True, help="predictions yaml from `evaluate`")
    p.add_argument("--roc-auc", action="store_true")
    p.add_argument("--beam-size", type=int, default=3)
    p.add_argument("--max-images", type=int, default=None)
    p.set_defaults(fn=cmd_analyze_words)

    p = sub.add_parser("parity",
                       help="published-checkpoint parity: decode + explain one image from a "
                            "reference .hdf5 and diff against a recorded expectation")
    _add_common(p)
    p.add_argument("--h5", required=True, help="reference Keras .hdf5 checkpoint")
    p.add_argument("--image", required=True, help="image file to caption and explain")
    p.add_argument("--expect", default=None, help="dir with parity-expected.npz to diff against")
    p.add_argument("--out", default=None, help="record the expectation here (default <h5>.parity)")
    p.add_argument("--method", default="lrp", choices=list(_METHOD_CHOICES))
    p.add_argument("--beam-size", type=int, default=3)
    p.add_argument("--tol", type=float, default=1e-3,
                   help="max allowed map deviation as a fraction of the expectation's scale")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("serve", help="HTTP/gRPC caption and explanation service")
    _add_common(p)
    # default None: with --exported the artifact pins the method
    p.add_argument("--method", default=None, choices=list(_METHOD_CHOICES))
    p.add_argument("--beam-size", type=int, default=3)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 binds a free port (printed)")
    p.add_argument("--transport", default="http", choices=("http", "grpc"))
    p.add_argument("--mesh", type=int, default=0,
                   help="shard request batches over an N-device data-parallel mesh")
    p.add_argument("--split-buckets", dest="split_buckets", action="store_true",
                   help="explain requests dispatch per caption-length bucket at ladder "
                        "sub-batch sizes (latency mode)")
    p.add_argument("--shard-words", action="store_true",
                   help="with --mesh: shard single-image explain requests over the mesh's "
                        "devices (latency mode)")
    p.add_argument("--linger-ms", type=float, default=5.0,
                   help="micro-batching window for concurrent requests")
    p.add_argument("--with-explain", action="store_true",
                   help="also warm the explanation endpoint (every graph it replays)")
    p.add_argument("--serve-seconds", type=float, default=None,
                   help="exit after N seconds (tests, smoke); default: run until interrupted")
    p.add_argument("--exported", default=None, metavar="DIR",
                   help="serve from an export-serving artifact instead of building the model")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export-serving",
                       help="trace the decode and explain programs into a torch.export artifact")
    _add_common(p)
    p.add_argument("--method", default="lrp", choices=list(_METHOD_CHOICES))
    p.add_argument("--beam-size", type=int, default=3)
    p.add_argument("--with-explain", action="store_true",
                   help="also export the bucketed explain programs")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_export_serving)

    args = ap.parse_args(argv)
    if args.profile:
        from .utils.profiling import trace

        with trace(args.profile):
            args.fn(args)
    else:
        args.fn(args)


if __name__ == "__main__":
    main()
