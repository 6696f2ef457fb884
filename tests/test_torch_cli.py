"""PyTorch port: the CLI's subcommands on the mini-Flickr30k fixture, with
``--device cpu`` at a small size: ``train``, ``evaluate`` and
``finetune-lrp``; ``explain``, ``evaluate-bbox`` and ``analyze-words``. Against
the JAX package's CLI from one npz of params: ``evaluate``'s metric dicts
are exactly equal (the same batches and params give the same captions,
compared exactly), and so are ``analyze-words``' mAP and ROC-AUC lines.
"""

import glob
import os

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu import cli as jcli  # noqa: E402
from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.train.checkpoint import save_params_npz  # noqa: E402
import torch_fixture  # noqa: E402
from lrp_imagecaptioning_torch import cli  # noqa: E402
from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k  # noqa: E402
from lrp_imagecaptioning_torch.explain import engine  # noqa: E402

torch.set_num_threads(2)

SETS = {"image_size": "32,32", "layer_name": "block3_conv1", "img_feature_length": "64",
        "img_feature_dim": "256", "embedding_dim": "16", "hidden_dim": "16",
        "sentence_length": "6", "words_min_occur": "1", "rare_words_handling": "nothing",
        "drop_rate": "0.0"}
VOCAB = 41   # the fixture's words with words_min_occur=1, and SOS / EOS


def _common(root, model_type="adaptiveattention", device=("--device", "cpu")):
    args = ["--dataset", "flickr30k", "--dataset-root", root, "--model", model_type,
            "--batch-size", "4", *device]
    for k, v in SETS.items():
        args += ["--set", f"{k}={v}"]
    return args


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini30k"))
    write_mini_flickr30k(root)
    return root


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_train_evaluate_finetune_end_to_end(corpus, tmp_path, monkeypatch, capsys, model_type):
    monkeypatch.chdir(tmp_path)
    common = _common(corpus, model_type)
    cli.main(["--profile", "prof", "train", *common, "--label", "e2e", "--epochs", "2"])
    assert os.path.getsize("prof/trace.json") > 0
    run_dir = "results/flickr30k/training-results/e2e"
    ckpts = sorted(glob.glob(f"{run_dir}/ckpt_*.npz"))
    assert [os.path.basename(c)[:7] for c in ckpts] == ["ckpt_00", "ckpt_01"]
    for name in ("config.yaml", "metrics-log.csv"):
        assert os.path.exists(os.path.join(run_dir, name))
    with open(os.path.join(run_dir, "config.yaml")) as f:
        assert yaml.safe_load(f)["hidden_dim"] == 16

    cli.main(["train", *common, "--label", "e2e", "--epochs", "3", "--resume"])
    assert sorted(glob.glob(f"{run_dir}/ckpt_02_*.npz"))

    cli.main(["evaluate", *common, "--weights", ckpts[-1], "--beam-size", "3", "--out", "ev",
              "--spice-detailed"])
    with open("ev/test-metrics.yaml") as f:
        metrics = yaml.safe_load(f)
    assert 0.0 <= metrics["Bleu_1"] <= 1.0 and "SPICE_Object" in metrics
    with open("ev/test-predictions.yaml") as f:
        assert sorted(yaml.safe_load(f)) == ["1016887272.jpg", "1019077836.jpg"]
    assert os.path.exists("ev/test-reference.yaml")

    cli.main(["finetune-lrp", *common, "--weights", ckpts[-1], "--chunks", "1",
              "--epoch-length", "1", "--out", "ft"])
    assert "chunk 0: {'loss'" in capsys.readouterr().out
    assert glob.glob("ft/ckpt_00_*.npz")


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_evaluate_metrics_equal_jax_cli(corpus, tmp_path, monkeypatch, model_type):
    monkeypatch.chdir(tmp_path)
    cfg = JConfig(embedding_dim=16, hidden_dim=16, image_size=(32, 32), layer_name="block3_conv1",
                  img_feature_length=64, img_feature_dim=256)
    pj = j_build(model_type, cfg, VOCAB).init_params(jax.random.PRNGKey(4))
    d = pj["decoder"]   # captions that vary (tests/test_torch_inference_api.py)
    for name in ("image_features", "global_img_feature"):
        d[name]["kernel"] = d[name]["kernel"] * 0.01
    d["embedding"] = d["embedding"] * 10
    d["output"]["kernel"] = d["output"]["kernel"] * 10
    d["output"]["bias"] = np.random.default_rng(1).normal(size=VOCAB).astype(np.float32) * 3
    save_params_npz("init.npz", jax.tree.map(np.asarray, pj))
    out = {}
    for side, main, device in (("jax", jcli.main, ()), ("torch", cli.main, ("--device", "cpu"))):
        main(["evaluate", *_common(corpus, model_type, device), "--weights", "init.npz",
              "--beam-size", "3", "--out", side])
        out[side] = {}
        for name in ("metrics", "predictions", "reference"):
            with open(f"{side}/test-{name}.yaml") as f:
                out[side][name] = yaml.safe_load(f)
    assert out["torch"] == out["jax"]
    assert out["torch"]["metrics"]["Bleu_1"] > 0


@pytest.mark.parametrize("argv, exc, match", [
    (["train", "--num-devices", "2"], NotImplementedError, "A13"),
    (["train", "--steps-per-call", "2"], NotImplementedError, "K-steps-a-call"),
    (["finetune-lrp", "--steps-per-call", "4"], NotImplementedError, "K-steps-a-call"),
    (["evaluate", "--weights", "orbax_ckpt_dir"], ValueError, "save_params_npz"),
    (["train", "--set", "no_such_field=1"], SystemExit, "no_such_field"),
])
def test_rejected_options_raise(corpus, tmp_path, monkeypatch, argv, exc, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(exc, match=match):
        cli.main([argv[0], *_common(corpus), *argv[1:]])


@pytest.mark.parametrize("cmd", ["train", "evaluate", "finetune-lrp", "explain", "evaluate-bbox",
                                 "analyze-words"])
def test_default_device_is_the_card(corpus, tmp_path, monkeypatch, cmd):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with open("preds.yaml", "w") as f:
        yaml.safe_dump({"1016887272.jpg": [{"caption": "a dog"}]}, f)
    extra = {"train": ["--epochs", "1"], "evaluate": [], "finetune-lrp": ["--chunks", "1"],
             "explain": [],
             "evaluate-bbox": ["--entities-json", os.path.join(corpus, "Flickr30kEntities.json")],
             "analyze-words": ["--predictions", "preds.yaml", "--roc-auc"]}[cmd]
    with pytest.raises(RuntimeError, match="device='cuda'"):
        cli.main([cmd, *_common(corpus, device=()), *extra])


def test_help_lists_only_ported_subcommands(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    text = capsys.readouterr().out
    subcommands = text[text.index("{") + 1:text.index("}")].split(",")
    assert subcommands == ["train", "finetune-lrp", "evaluate", "explain", "evaluate-bbox",
                           "analyze-words", "parity", "serve", "export-serving"]
    assert "--profile" in text and "--jax-cache" not in text


def test_method_choices_equal_engine():
    assert cli._METHOD_CHOICES == engine.METHODS


def _fixture_npz(corpus, path, model_type):
    """The JAX init of tests/torch_fixture.py (captions that hit the test
    images' categories) as one flat params npz."""
    sides = torch_fixture.build(corpus, model_type)
    save_params_npz(path, jax.tree.map(np.asarray, sides["jax"]["params"]))


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_explain_evaluate_bbox_analyze_words_end_to_end(corpus, tmp_path, monkeypatch, capsys,
                                                        model_type):
    """The three subcommands' outputs, checked as tests/test_cli_e2e.py
    checks the JAX CLI's."""
    monkeypatch.chdir(tmp_path)
    _fixture_npz(corpus, "w.npz", model_type)
    common = [*_common(corpus, model_type), "--weights", "w.npz"]
    img = os.path.join(corpus, "Flickr30k_images", "1015118661.jpg")
    cli.main(["explain", *common, "--image", img, "--method", "deep_lift", "--out", "ex"])
    rendered = glob.glob("ex/**/*.jpg", recursive=True)
    assert any(p.endswith("deep_lift_hm.jpg") for p in rendered), rendered
    assert any(p.endswith("attention.jpg") for p in rendered), rendered
    cli.main(["explain", *common, "--num-images", "2", "--out", "ex2"])
    assert sorted(os.listdir("ex2")) == ["1016887272", "1019077836"]
    capsys.readouterr()

    cli.main(["evaluate-bbox", *common, "--entities-json",
              os.path.join(corpus, "Flickr30kEntities.json"), "--max-images", "2",
              "--out", "bbox/correctness.json"])
    with open("bbox/correctness.json") as f:
        results = json.load(f)
    assert sorted(results) == ["1016887272.jpg", "1019077836.jpg"]
    assert os.path.exists("bbox/correctness.csv")
    assert "'lrp':" in capsys.readouterr().out

    cli.main(["evaluate", *common, "--beam-size", "3", "--out", "ev"])
    cli.main(["analyze-words", *common, "--predictions", "ev/test-predictions.yaml"])
    assert "frequent-object mAP:" in capsys.readouterr().out
    # the ROC-AUCs need a frequent object in the predictions ("dog")
    with open("preds.yaml", "w") as f:
        yaml.safe_dump({"1016887272.jpg": [{"caption": "a green dog"}],
                        "1019077836.jpg": [{"caption": "a dog"}]}, f)
    cli.main(["analyze-words", *common, "--predictions", "preds.yaml", "--roc-auc"])
    out = capsys.readouterr().out
    # dog: AP 1 over len(FREQUENT_OBJECT) - 1 = 8 (the reference's divisor)
    assert "frequent-object mAP: 12.5" in out and "ROC-AUC beta=" in out


def test_analyze_words_lines_equal_jax_cli(corpus, tmp_path, monkeypatch, capsys):
    """analyze-words from one npz and one predictions file: the JAX CLI's mAP
    and ROC-AUC lines, character for character."""
    monkeypatch.chdir(tmp_path)
    _fixture_npz(corpus, "w.npz", "adaptiveattention")
    with open("preds.yaml", "w") as f:    # "dog" is in the first image's references only
        yaml.safe_dump({"1016887272.jpg": [{"caption": "a green dog"}],
                        "1019077836.jpg": [{"caption": "a dog near a man"}]}, f)
    lines = {}
    for side, main, device in (("jax", jcli.main, ()), ("torch", cli.main, ("--device", "cpu"))):
        main(["analyze-words", *_common(corpus, "adaptiveattention", device), "--weights",
              "w.npz", "--predictions", "preds.yaml", "--roc-auc"])
        lines[side] = [ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith(("frequent-object mAP:", "ROC-AUC"))]
    assert len(lines["torch"]) == 2 and lines["torch"] == lines["jax"]
    assert lines["torch"][0] != "frequent-object mAP: 0.0"
