"""PyTorch port: the entry points of K steps a call (``steps_per_call``,
``--steps-per-call``) against the JAX package's on the CPU: the Trainer,
the LRP fine-tuner and the CLI's ``train`` and ``finetune-lrp``, each at
K = 2 over 3 batches (a call of 2, then the ragged step as a single step),
without dropout, from one set of params.

Tolerances: per-epoch (per-chunk) loss and accuracy within 1e-5 of their
scale, as tests/test_torch_trainer.py holds the trainers (the Trainer at its
config's lr 2e-4, its validation loss after the last update); the
fine-tuner at lr 1e-3, the update of its chunk's 3 steps against the JAX
package's as tests/test_torch_multi_step.py holds a K-step call's (its
docstring says why).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.train import lrp_finetune as jft  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.train import lrp_finetune as tft  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_multi_step import _assert_update_close  # noqa: E402

torch.set_num_threads(2)

KW = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
          img_feature_dim=128, sentence_length=6, batch_size=4, drop_rate=0.0)
VOCAB, B, T, LR = 32, 4, 7, 1e-3


def _batches(seed, K, batch=B):
    """K batches (images, captions in, one-hot labels), stacked on axis 0."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(K, batch, 8, 8, 3)).astype(np.float32)
    caps = rng.integers(0, VOCAB, size=(K, batch, T)).astype(np.int32)
    y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(K, batch, T))]
    y[:, 0, -2:] = 0                   # padding rows
    y[:, 1, -4:] = 0
    return images, caps, y


def test_trainer_steps_per_call_matches_jax(tmp_path, monkeypatch):
    """Trainer(steps_per_call=2) against the JAX one on the mini-Flickr30k
    fixture, from one npz, without dropout: one epoch of 3 steps (a call of
    2, then the ragged step), the losses and the checkpoint's count; 0 is
    1, as in JAX. The validation loss is taken after the epoch's last
    update."""
    from lrp_imagecaptioning_tpu.data.datasets import Flickr30kDataset as JDataset
    from lrp_imagecaptioning_tpu.data.minifixture import write_mini_flickr30k
    from lrp_imagecaptioning_tpu.train import trainer as jtrainer
    from lrp_imagecaptioning_tpu.train.checkpoint import save_params_npz
    from lrp_imagecaptioning_torch.data.datasets import Flickr30kDataset as TDataset
    from lrp_imagecaptioning_torch.train import trainer as ttrainer

    root = str(tmp_path / "mini30k")
    write_mini_flickr30k(root)
    kw = dict(batch_size=4, image_size=(32, 32), layer_name="block3_conv1",
              img_feature_length=64, img_feature_dim=256, embedding_dim=16, hidden_dim=16,
              sentence_length=6, words_min_occur=1, rare_words_handling="nothing",
              drop_rate=0.0, dataset_root=root)
    hist = {}
    for side in ("jax", "torch"):
        monkeypatch.chdir(tmp_path)
        os.makedirs(side)
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            cfg = JConfig(**kw)
            t = jtrainer.Trainer("adaptiveattention", cfg, JDataset(cfg), eval_metrics=False,
                                 steps_per_call=2)
            npz = str(tmp_path / "init.npz")
            save_params_npz(npz, jax.tree.map(np.asarray, t.params))
        else:
            cfg = TConfig(**kw)
            t = ttrainer.Trainer("adaptiveattention", cfg, TDataset(cfg), eval_metrics=False,
                                 steps_per_call=2, device="cpu")
            assert ttrainer.Trainer("adaptiveattention", cfg, TDataset(cfg), eval_metrics=False,
                                    steps_per_call=0, device="cpu")._multi_step is None
        t.load_weights(npz)
        hist[side] = t.run(epochs=1, steps_per_epoch=3)
    assert t.opt_state["count"] == 3
    for k in ("loss", "accuracy", "val_loss", "val_accuracy"):
        got, want = hist["torch"][0][k], hist["jax"][0][k]
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-6), (k, got, want)


class _PP:
    vocab_size = VOCAB
    word_of = {tok: ("the" if tok == 5 else f"w{tok}") for tok in range(1, VOCAB + 1)}
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2


class _Provider:
    """Duck-typed provider over ready batches ((captions_in, images), y)."""

    caption_preprocessor = _PP()

    def __init__(self, batches):
        self.batches = batches

    def training_set(self, pad_to_length, skip_batches=0, drop_remainder=False):
        for images, caps, y in self.batches[skip_batches:]:
            yield (caps, images), y


def test_lrp_finetuner_steps_per_call_matches_jax(tmp_path):
    """LRPFinetuner(steps_per_call=2) against the JAX one over 3 batches (a
    call of 2, then the ragged step), without dropout: the chunk's metrics
    and the params."""
    jcap = j_build("adaptiveattention", JConfig(**KW, image_size=(8, 8)), VOCAB)
    tcap = t_build("adaptiveattention", TConfig(**KW), VOCAB)
    pj = jcap.init_params(jax.random.PRNGKey(0))
    pt = params_from_jax(pj, "cpu")
    images, caps, y = _batches(6, 3)
    batches = [(images[k], caps[k], y[k]) for k in range(3)]
    tuner = tft.LRPFinetuner(tcap, pt, _Provider(batches), learning_rate=LR, steps_per_call=2,
                             device="cpu")
    got = tuner.run(save_idx=0, epoch_length=3, result_dir=str(tmp_path / "torch"))
    jtuner = jft.LRPFinetuner(jcap, pj, _Provider(batches), learning_rate=LR, steps_per_call=2)
    want = jtuner.run(save_idx=0, epoch_length=3, result_dir=str(tmp_path / "jax"))
    assert tuner.opt_state["count"] == 3
    for k in ("loss", "accuracy"):
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), (k, got, want)
    _assert_update_close(pt, tuner.params, jtuner.params)


@pytest.mark.parametrize("slots", [1, 2])
def test_lrp_finetuner_steps_per_call_on_a_mesh(tmp_path, slots):
    """LRPFinetuner(steps_per_call=2) on a mesh: of one slot it runs the
    one-device K-step call (the one a card replays from a captured step;
    ``train.step.one_device_mesh``) on unsplit stacks, of two the sharded
    steps chained; either ends on the one-device fine-tuner's chunk."""
    from lrp_imagecaptioning_torch.parallel import Sharded, make_mesh

    tcap = t_build("adaptiveattention", TConfig(**KW), VOCAB)
    pt = tcap.init_params(0, device="cpu")
    images, caps, y = _batches(9, 3)
    batches = [(images[k], caps[k], y[k]) for k in range(3)]
    runs = {}
    for mesh in (None, make_mesh(devices=["cpu"] * slots)):
        tuner = tft.LRPFinetuner(tcap, pt, _Provider(batches), learning_rate=LR,
                                 steps_per_call=2, mesh=mesh, device="cpu")
        runs[mesh is None] = (tuner, tuner.run(save_idx=0, epoch_length=3,
                                               result_dir=str(tmp_path / str(mesh is None))))
    tuner, got = runs[False]
    assert hasattr(tuner._multi_step, "graph") == (slots == 1)
    assert isinstance(tuner._place_stacked(images[:2]), Sharded) == (slots == 2)
    want = runs[True][1]
    for k in ("loss", "accuracy"):
        assert abs(got[k] - want[k]) <= 1e-6 * max(abs(want[k]), 1e-6), (k, got, want)
    assert tuner.opt_state["count"] == 3
    _assert_update_close(pt, tuner.params, runs[True][0].params)


@pytest.mark.parametrize("cmd", ["train", "finetune-lrp"])
def test_cli_steps_per_call_as_jax_cli(tmp_path, monkeypatch, capsys, cmd):
    """``--steps-per-call`` of both CLIs on the mini-Flickr30k fixture: each
    builds its Trainer or LRPFinetuner with the same K from the same flags
    (0 is 1); the port's command then runs to its end on the CPU at K = 2 (a
    call of 2 steps, the ragged rest as singles), its Adam count the steps
    it took. The JAX CLI's runs are stubbed: its trainer and fine-tuner
    are held to the port's above, and its compiles cost minutes here."""
    from lrp_imagecaptioning_tpu import cli as jcli
    from lrp_imagecaptioning_tpu.data.minifixture import write_mini_flickr30k
    from lrp_imagecaptioning_tpu.train import lrp_finetune as jft_mod
    from lrp_imagecaptioning_tpu.train import trainer as jtrainer
    from lrp_imagecaptioning_torch import cli
    from lrp_imagecaptioning_torch.train import lrp_finetune as tft_mod
    from lrp_imagecaptioning_torch.train import trainer as ttrainer

    root = str(tmp_path / "mini30k")
    write_mini_flickr30k(root)
    sets = {"image_size": "32,32", "layer_name": "block3_conv1", "img_feature_length": "64",
            "img_feature_dim": "256", "embedding_dim": "16", "hidden_dim": "16",
            "sentence_length": "6", "words_min_occur": "1", "rare_words_handling": "nothing",
            "drop_rate": "0.0"}
    common = ["--dataset", "flickr30k", "--dataset-root", root, "--model", "adaptiveattention",
              "--batch-size", "4", *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]
    extra = (["--label", "k", "--epochs", "1"] if cmd == "train"
             else ["--chunks", "1", "--epoch-length", "3", "--out", "ft"])
    monkeypatch.chdir(tmp_path)
    built = {}

    def recorded(side, real):
        class Recorded(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.setdefault((side, kw.get("steps_per_call")), []).append(self)

            if side == "jax":
                def run(self, *a, **kw):
                    return [] if real.__name__ == "Trainer" else {"loss": 0.0, "accuracy": 0.0}

        return Recorded

    for side, module, cls in (("jax", jtrainer, "Trainer"), ("jax", jft_mod, "LRPFinetuner"),
                              ("torch", ttrainer, "Trainer"), ("torch", tft_mod, "LRPFinetuner")):
        monkeypatch.setattr(module, cls, recorded(side, getattr(module, cls)))
    for k in ("0", "2"):
        jcli.main([cmd, *common, *extra, "--steps-per-call", k])
        cli.main([cmd, *common, *extra, "--device", "cpu", "--steps-per-call", k])
    for k, want in ((0, 1), (2, 2)):
        (j,), (t,) = built[("jax", k)], built[("torch", k)]
        assert j._steps_per_call == t._steps_per_call == want
        assert (t._multi_step is None) == (j._multi_step is None) == (want == 1)
    t = built[("torch", 2)][0]
    steps = t.provider.training_steps if cmd == "train" else 3
    assert t.opt_state["count"] == steps and steps > 2
    out = capsys.readouterr().out
    assert ("epoch 0: loss=" if cmd == "train" else "chunk 0: {'loss'") in out
