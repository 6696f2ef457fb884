"""Command line of the port: the published-checkpoint parity harness.

    python -m lrp_imagecaptioning_torch.cli parity --h5 ckpt.hdf5 --image img.png --out DIR
    python -m lrp_imagecaptioning_torch.cli parity --h5 ckpt.hdf5 --image img.png --expect DIR

It reads and writes the ``parity-expected.npz`` of the JAX package's
``cli.py parity`` (keys ``tokens_1based``, ``relevance_maps``,
``attentions``), so one recording checks both packages. ``--device``
defaults to ``cuda``. The other subcommands of the JAX package's CLI are
not ported yet (ROADMAP A10b).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from types import SimpleNamespace

import numpy as np

from .explain.engine import METHODS


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
    if isinstance(current, tuple) or (current is None and "tuple" in str(fields[key].type)):
        vals = tuple(int(x) for x in raw.split(","))
        return vals * 2 if len(vals) == 1 else vals   # "64" -> (64, 64)
    return raw


def _build_config(args):
    """FlickrConfig with the --set overrides (no dataset files are read)."""
    from .config import FlickrConfig

    cfg = FlickrConfig()
    overrides = {}
    for kv in args.config_set or ():
        key, _, raw = kv.partition("=")
        overrides[key] = _coerce_config_value(cfg, key, raw)
    return cfg.replace(**overrides) if overrides else cfg


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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lrp_imagecaptioning_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("parity",
                       help="published-checkpoint parity: decode + explain one image from a "
                            "reference .hdf5 and diff against a recorded expectation")
    p.add_argument("--model", dest="model_type", default="adaptiveattention",
                   choices=["adaptiveattention", "gridTD"])
    p.add_argument("--set", dest="config_set", action="append", metavar="KEY=VALUE",
                   help="override a field of FlickrConfig, e.g. --set image_size=8,8 "
                        "(repeatable)")
    p.add_argument("--h5", required=True, help="reference Keras .hdf5 checkpoint")
    p.add_argument("--image", required=True, help="image file to caption and explain")
    p.add_argument("--expect", default=None, help="dir with parity-expected.npz to diff against")
    p.add_argument("--out", default=None, help="record the expectation here (default <h5>.parity)")
    p.add_argument("--method", default="lrp",
                   choices=[m for m in METHODS if m not in ("deep_taylor", "deep_lift")])
    p.add_argument("--beam-size", type=int, default=3)
    p.add_argument("--tol", type=float, default=1e-3,
                   help="max allowed map deviation as a fraction of the expectation's scale")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_parity)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
