"""PyTorch port: the trainer and its callbacks against the JAX package on the
CPU, on the mini-Flickr30k fixture.

Both trainers start from one npz of the JAX init's params, without dropout,
and run two epochs of two steps (FlickrConfig's lr 2e-4, plateau patience 0,
so the learning rate halves at the first epoch whose val CIDEr does not
improve).
Tolerances, each with its reason:
* per-epoch loss, accuracy and val_loss within 1e-5 of their scale: f32
  sums in another order, through four Adam steps. Adam's first steps are
  lr sign(g), and where |g| ~ eps a last-ulp difference flips a sign: at lr
  1e-3 the second epoch's loss read 1.2e-5 apart, at 2e-4 (the config's) it
  scales down with lr;
* learning rates, the plateau's epochs, CSV columns, checkpoint names and
  the config snapshot (parsed) exactly equal.
"""

import csv
import os
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.data.datasets import Flickr30kDataset as JDataset  # noqa: E402
from lrp_imagecaptioning_tpu.data.minifixture import write_mini_flickr30k  # noqa: E402
from lrp_imagecaptioning_tpu.train import callbacks as jcb  # noqa: E402
from lrp_imagecaptioning_tpu.train import trainer as jtrainer  # noqa: E402
from lrp_imagecaptioning_tpu.train.checkpoint import save_params_npz  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.data.datasets import Flickr30kDataset as TDataset  # noqa: E402
from lrp_imagecaptioning_torch.train import callbacks as tcb  # noqa: E402
from lrp_imagecaptioning_torch.train import trainer as ttrainer  # noqa: E402

torch.set_num_threads(2)

KW = dict(batch_size=4, image_size=(32, 32), layer_name="block3_conv1", img_feature_length=64,
          img_feature_dim=256, embedding_dim=16, hidden_dim=16, sentence_length=6,
          words_min_occur=1, rare_words_handling="nothing", drop_rate=0.0, reduce_lr_patience=0)
MODELS = ["adaptiveattention", "gridTD"]


@pytest.mark.parametrize("s", ["12 hours", "30 minutes", "1 day", "2.5 weeks", "1 second",
                               None, "", "12h", "2 fortnights", "a b c"])
def test_parse_timedelta_matches_jax(s):
    try:
        want = jtrainer.parse_timedelta(s)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ttrainer.parse_timedelta(s)
        assert str(got.value) == str(e)
        return
    assert ttrainer.parse_timedelta(s) == want


def test_csvlog_append_matches_jax(tmp_path):
    for mod, name in ((tcb, "t.csv"), (jcb, "j.csv")):
        path = str(tmp_path / name)
        log = mod.CSVLog(path)
        log.on_epoch_end(0, {"loss": 1.0, "flag": True})
        log.on_epoch_end(1, {"loss": 0.5, "flag": False})
        log.close()
        resumed = mod.CSVLog(path, append=True)
        resumed.on_epoch_end(2, {"loss": 0.25, "extra": 9})   # the extra column is dropped
        resumed.close()
    got, want = (tmp_path / "t.csv").read_text(), (tmp_path / "j.csv").read_text()
    assert got == want
    rows = list(csv.DictReader(open(tmp_path / "t.csv", newline="")))
    assert [r["epoch"] for r in rows] == ["0", "1", "2"] and rows[2]["loss"] == "0.25"


@pytest.mark.parametrize("patience", [0, 1, 2])
def test_reduce_lr_on_plateau_matches_jax(patience):
    rng = np.random.default_rng(patience)
    values = list(rng.choice([0.1, 0.2, 0.3, 0.30005, None], size=12))
    got_p = tcb.ReduceLROnPlateau(factor=0.5, patience=patience, min_lr=1e-5)
    want_p = jcb.ReduceLROnPlateau(factor=0.5, patience=patience, min_lr=1e-5)
    lr_t = lr_j = 1e-3
    for v in values:
        logs = {} if v is None else {"val_cider": float(v)}
        lr_t, lr_j = got_p.update(logs, lr_t), want_p.update(logs, lr_j)
        assert lr_t == lr_j


def test_stop_conditions_match_jax():
    for mod in (tcb, jcb):
        assert not mod.StopAfterTimedelta(None).should_stop()
        assert mod.StopAfterTimedelta(timedelta(seconds=-1)).should_stop()
        assert not mod.StopAfterTimedelta(timedelta(hours=1)).should_stop()
    losses = [3.0, 2.0, 2.5, 19.9, None, 20.1, 1.0, 10.5]
    got_s, want_s = tcb.StopWhenValLossExploding(), jcb.StopWhenValLossExploding()
    got = [got_s.should_stop(v) for v in losses]
    assert got == [want_s.should_stop(v) for v in losses]
    assert got.count(True) == 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each decoder: the port's and the JAX trainer's histories after
    run(epochs=2, steps_per_epoch=2) from one npz, in their own cwd."""
    base = tmp_path_factory.mktemp("trainers")
    root = str(base / "mini30k")
    write_mini_flickr30k(root)
    out = {}
    cwd = os.getcwd()
    try:
        for model_type in MODELS:
            res = {}
            for side in ("jax", "torch"):
                d = base / f"{model_type}-{side}"
                d.mkdir()
                os.chdir(d)
                if side == "jax":
                    cfg = JConfig(dataset_root=root, **KW)
                    t = jtrainer.Trainer(model_type, cfg, JDataset(cfg), label="itest")
                    npz = str(base / f"{model_type}-init.npz")
                    save_params_npz(npz, jax.tree.map(np.asarray, t.params))
                else:
                    cfg = TConfig(dataset_root=root, **KW)
                    t = ttrainer.Trainer(model_type, cfg, TDataset(cfg), label="itest",
                                         device="cpu")
                t.load_weights(npz)
                res[side] = dict(history=t.run(epochs=2, steps_per_epoch=2),
                                 dir=str(d / t.result_dir), trainer=t, cwd=str(d))
            out[model_type] = res
    finally:
        os.chdir(cwd)
    return out


@pytest.mark.parametrize("model_type", MODELS)
def test_trainer_epochs_match_jax(runs, model_type):
    got, want = runs[model_type]["torch"]["history"], runs[model_type]["jax"]["history"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "accuracy", "val_loss", "val_accuracy"):
            assert np.isfinite(g[k])
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1e-6), (k, g[k], w[k])
        assert g["learning_rate"] == w["learning_rate"]
        assert "val_cider" in g and "val_bleu_4" in g and "val_spice" in g
    # patience 0: the plateau halves the rate at the same epochs
    assert [g["learning_rate"] for g in got] == [w["learning_rate"] for w in want]
    assert got[-1]["learning_rate"] < float(np.float32(2e-4)) or \
        got[-1]["val_cider"] > got[0]["val_cider"] + 1e-4


@pytest.mark.parametrize("model_type", MODELS)
def test_trainer_csv_checkpoints_and_snapshot_match_jax(runs, model_type):
    t_dir, j_dir = runs[model_type]["torch"]["dir"], runs[model_type]["jax"]["dir"]
    rows = {}
    for side, d in (("torch", t_dir), ("jax", j_dir)):
        with open(os.path.join(d, "metrics-log.csv"), newline="") as f:
            rows[side] = list(csv.reader(f))
    assert rows["torch"][0] == rows["jax"][0]
    assert [r[0] for r in rows["torch"][1:]] == ["0", "1"]
    stems = lambda d: sorted(n[:-4] if n.endswith(".npz") else n  # noqa: E731
                             for n in os.listdir(d) if n.startswith("ckpt_"))
    assert stems(t_dir) == stems(j_dir) and len(stems(t_dir)) == 2
    snap = [yaml.safe_load(open(os.path.join(d, "config.yaml"))) for d in (t_dir, j_dir)]
    assert snap[0] == snap[1]
    assert snap[0]["image_size"] == [32, 32] and snap[0]["reduce_lr_patience"] == 0


@pytest.mark.parametrize("model_type", MODELS)
def test_trainer_resume_continues_the_numbering(runs, model_type):
    r = runs[model_type]["torch"]
    cwd = os.getcwd()
    os.chdir(r["cwd"])
    try:
        t1 = r["trainer"]
        t2 = ttrainer.Trainer(model_type, t1.config, t1.dataset, label="itest", device="cpu")
        assert t2.resume_latest()
        assert t2._initial_epoch == 2
        assert t2.run(epochs=2) == []          # epochs is the total target
        for k, v in t1.params["decoder"]["output"].items():
            assert torch.equal(t2.params["decoder"]["output"][k], v)
        assert t2.opt_state["count"] == t1.opt_state["count"] == 4
        hist = t2.run(epochs=3, steps_per_epoch=1)
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
        with open(os.path.join(t2.result_dir, "metrics-log.csv"), newline="") as f:
            assert [row[0] for row in csv.reader(f)][1:] == ["0", "1", "2"]
        assert os.path.basename(ttrainer.latest_checkpoint(t2.result_dir)).startswith("ckpt_02_")
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("kw, match", [
    ({"mesh": object()}, "A13"), ({"multihost": True}, "A13"),
    ({"steps_per_call": 4}, "K-steps-a-call")])
def test_trainer_rejects_unported_options(runs, kw, match):
    t1 = runs["adaptiveattention"]["torch"]["trainer"]
    with pytest.raises(NotImplementedError, match=match):
        ttrainer.Trainer("adaptiveattention", t1.config, t1.dataset, device="cpu", **kw)
