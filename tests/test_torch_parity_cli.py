"""PyTorch port: the weights importer (``models/weights_io.py``) and the
``parity`` command (``cli.py``) across packages.

An H5 minted by the JAX package's ``save_reference_checkpoint_h5`` (the
reference's Keras ``save_weights`` format) loads into the same params in
both packages; an expectation recorded by the JAX ``cli parity`` is diffed
by the port's command (PARITY OK, exit 0) and fails against other weights
(PARITY FAIL, exit 1), and the other way round. The tolerance is the JAX
command's default (1e-3 of the expectation's scale).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu import cli as jcli  # noqa: E402
from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.models.weights_io import (  # noqa: E402
    infer_h5_dims as j_infer, load_reference_checkpoint_h5 as j_load, save_reference_checkpoint_h5)
from lrp_imagecaptioning_torch import cli as tcli  # noqa: E402
from lrp_imagecaptioning_torch.models import weights_io as tio  # noqa: E402
from lrp_imagecaptioning_torch.weights import tree_leaves  # noqa: E402

torch.set_num_threads(2)

CFG = JConfig(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
              img_feature_dim=128, image_size=(8, 8), sentence_length=5, drop_rate=0.0)
VOCAB = 16
COMMON = ["--set", "image_size=8,8", "--set", "img_feature_length=16",
          "--set", "img_feature_dim=128", "--set", "layer_name=block2_conv1",
          "--set", "sentence_length=5", "--set", "drop_rate=0.0"]


def _port_args(model_type):
    args = ["--model", model_type]
    for kv in ("image_size=8,8", "img_feature_length=16", "img_feature_dim=128",
               "layer_name=block2_conv1", "sentence_length=5"):
        args += ["--set", kv]
    return args + ["--device", "cpu", "--beam-size", "2"]


def _mint_h5(tmp_path, model_type, seed, name):
    params = j_build(model_type, CFG, VOCAB).init_params(jax.random.PRNGKey(seed))
    path = str(tmp_path / name)
    save_reference_checkpoint_h5(path, params, model_type, arch="vgg16", until=CFG.layer_name)
    return path, params


def _mint_image(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(7).uniform(0, 255, size=(12, 12, 3)).astype("uint8")
    path = str(tmp_path / "img.png")
    Image.fromarray(arr).save(path)
    return path


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_h5_loads_the_jax_params(tmp_path, model_type):
    path, params = _mint_h5(tmp_path, model_type, 0, "ref.h5")
    got = tio.load_reference_checkpoint_h5(path, model_type, until=CFG.layer_name, device="cpu")
    ref = j_load(path, model_type, "vgg16", CFG.layer_name)
    assert set(got) == {"vgg", "decoder"} and set(got["decoder"]) == set(ref["decoder"])
    for a, b, c in zip(tree_leaves(got), tree_leaves(ref), tree_leaves(params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert tio.infer_h5_dims(path) == j_infer(path) == {"vocab_size": VOCAB, "hidden_dim": 16,
                                                       "embedding_dim": 16}


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_port_diffs_a_jax_recording(tmp_path, model_type, capsys):
    h5 = _mint_h5(tmp_path, model_type, 0, "ref.h5")[0]
    img = _mint_image(tmp_path)
    expect = str(tmp_path / "expect")
    jcli.main(["parity", "--model", model_type, *COMMON, "--h5", h5, "--image", img,
               "--beam-size", "2", "--out", expect])
    capsys.readouterr()
    tcli.main(["parity", *_port_args(model_type), "--h5", h5, "--image", img, "--expect", expect])
    out = capsys.readouterr().out
    assert "PARITY OK" in out and "relevance_maps: max dev" in out


def test_port_fails_on_other_weights_and_jax_diffs_a_port_recording(tmp_path, capsys):
    h5_a = _mint_h5(tmp_path, "adaptiveattention", 0, "a.h5")[0]
    h5_b = _mint_h5(tmp_path, "adaptiveattention", 1, "b.h5")[0]
    img = _mint_image(tmp_path)
    expect = str(tmp_path / "expect")
    jcli.main(["parity", "--model", "adaptiveattention", *COMMON, "--h5", h5_a, "--image", img,
               "--beam-size", "2", "--out", expect])
    capsys.readouterr()
    with pytest.raises(SystemExit) as ei:
        tcli.main(["parity", *_port_args("adaptiveattention"), "--h5", h5_b, "--image", img,
                   "--expect", expect])
    assert "PARITY FAIL" in str(ei.value) and ei.value.code != 0
    # the port records, the JAX package checks
    mine = str(tmp_path / "mine")
    tcli.main(["parity", *_port_args("adaptiveattention"), "--h5", h5_a, "--image", img,
               "--out", mine])
    assert "recorded parity expectation" in capsys.readouterr().out
    jcli.main(["parity", "--model", "adaptiveattention", *COMMON, "--h5", h5_a, "--image", img,
               "--beam-size", "2", "--expect", mine])
    assert "PARITY OK" in capsys.readouterr().out


def test_parity_diff_matches_jax_on_edge_records():
    empty = {"tokens_1based": np.zeros((0,), np.int32),
             "relevance_maps": np.zeros((0, 8, 8, 3), np.float32),
             "attentions": np.zeros((0, 16), np.float32)}
    assert tcli.parity_diff(empty, dict(empty), 1e-4) == []
    got = dict(empty, relevance_maps=np.zeros((2, 8, 8, 3), np.float32))
    assert tcli.parity_diff(got, dict(empty), 1e-4) == jcli.parity_diff(got, dict(empty), 1e-4)
    rng = np.random.default_rng(1)
    a = {"tokens_1based": np.array([3, 4, 2, 0]), "relevance_maps": rng.normal(size=(2, 8, 8, 3)),
         "attentions": rng.normal(size=(2, 16))}
    b = dict(a, tokens_1based=np.array([3, 5, 2, 0]), attentions=a["attentions"] * 1.01)
    assert tcli.parity_diff(a, b, 1e-3) == jcli.parity_diff(a, b, 1e-3)


def test_config_overrides_parse_like_jax():
    cfg = tcli._build_config(tcli.argparse.Namespace(
        config_set=["image_size=8", "sentence_length=7", "layer_name=block2_conv1",
                    "compute_dtype=bfloat16"]))
    assert cfg.image_size == (8, 8) and cfg.sentence_length == 7
    assert cfg.layer_name == "block2_conv1" and cfg.compute_dtype == "bfloat16"
    with pytest.raises(SystemExit, match="unknown config field"):
        tcli._build_config(tcli.argparse.Namespace(config_set=["nope=1"]))
