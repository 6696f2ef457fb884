"""PyTorch port: word-level explanation analysis (``evalx/words.py``) against
the JAX package, and its numpy ROC curve against scikit-learn.

The port computes the ROC curve and its trapezoid AUC in numpy (the card's
host has no scikit-learn): they are held to ``sklearn.metrics.roc_curve`` and
``auc`` to 1e-12, on random and on tied scores. ``collect_word_stats`` runs
each package's Explainer on the mini-Flickr30k fixture with the same params:
beta to 1e-5, the projected means to 1e-4 of their scale.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sklearn_metrics = pytest.importorskip("sklearn.metrics")

import torch_fixture  # noqa: E402
from lrp_imagecaptioning_tpu.evalx import words as jw  # noqa: E402
from lrp_imagecaptioning_tpu.explain.engine import Explainer as JExplainer  # noqa: E402
from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k  # noqa: E402
from lrp_imagecaptioning_torch.evalx import words as tw  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini30k"))
    write_mini_flickr30k(root)
    return root


def test_category_lists_equal_jax():
    for name in ("FLICKR_CATEGORY", "COCO_CATEGORY", "FREQUENT_OBJECT", "COCO_FREQUENT_OBJECT"):
        assert getattr(tw, name) == getattr(jw, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frequent_object_map_equals_jax(seed):
    rng = np.random.default_rng(seed)
    vocab = ["man", "dog", "shirt", "woman", "a", "on", "street", "people", "bench"]

    def sentence():
        return " ".join(rng.choice(vocab, size=rng.integers(3, 8)))

    refs = {f"i{k}": [sentence() for _ in range(3)] for k in range(12)}
    preds = {f"i{k}": sentence() for k in range(10)}    # two images without a prediction
    for cats in (jw.FREQUENT_OBJECT, ["dog", "bench"], ["unicorn"]):
        got = tw.frequent_object_map(preds, refs, cats)
        assert got == jw.frequent_object_map(preds, refs, cats)
    # the reference's divisor: len(categories) - 1
    assert tw.frequent_object_map({"i": "a dog"}, {"i": ["a dog"]}, ["dog", "cat"]) == 100.0


@pytest.mark.parametrize("caption, category, index", [
    ("a dog and a cat", "cat", 4), ("a dog and a cat", "dog", 1), ("a dog", "cat", None),
    ("dogs dog", "dog", 1)])
def test_word_index_in_caption_equals_jax(caption, category, index):
    assert tw.word_index_in_caption(caption, category) == index
    assert jw.word_index_in_caption(caption, category) == index


def _assert_roc_equals_sklearn(labels, scores):
    fpr, tpr, thr = tw.roc_curve(labels, scores)
    s_fpr, s_tpr, s_thr = sklearn_metrics.roc_curve(labels, scores)
    for got, want in ((fpr, s_fpr), (tpr, s_tpr), (thr, s_thr)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert abs(tw.auc(fpr, tpr) - sklearn_metrics.auc(s_fpr, s_tpr)) <= 1e-12
    assert abs(tw._roc_auc(labels, scores)[2] - sklearn_metrics.roc_auc_score(labels, scores)) \
        <= 1e-12


@pytest.mark.parametrize("n", [2, 7, 50, 400])
@pytest.mark.parametrize("seed", [0, 1])
def test_roc_auc_equals_sklearn_random(n, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n)
    labels[0], labels[-1] = 0, 1
    _assert_roc_equals_sklearn(labels.tolist(), rng.normal(size=n).tolist())


@pytest.mark.parametrize("levels", [1, 2, 3, 5, 20])
def test_roc_auc_equals_sklearn_tied(levels):
    """Scores drawn from a few values: ties share one threshold."""
    rng = np.random.default_rng(levels)
    n = 200
    labels = rng.integers(0, 2, size=n)
    labels[:2] = [0, 1]
    scores = rng.integers(0, levels, size=n) / max(levels - 1, 1)
    _assert_roc_equals_sklearn(labels.tolist(), scores.tolist())


def test_roc_one_class_is_nan_as_sklearn():
    with pytest.warns(Warning):
        s_fpr, s_tpr, _ = sklearn_metrics.roc_curve([1, 1, 1], [0.1, 0.5, 0.3])
    fpr, tpr, _ = tw.roc_curve([1, 1, 1], [0.1, 0.5, 0.3])
    assert np.isnan(fpr).all() and np.isnan(s_fpr).all()
    np.testing.assert_array_equal(tpr, s_tpr)


def test_auc_direction_and_errors():
    assert tw.auc([1.0, 0.5, 0.0], [1.0, 1.0, 0.0]) == sklearn_metrics.auc([1.0, 0.5, 0.0],
                                                                          [1.0, 1.0, 0.0])
    with pytest.raises(ValueError, match="neither increasing nor decreasing"):
        tw.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])
    with pytest.raises(ValueError):
        tw.roc_curve([], [])


def _stats(seed=0, n=20):
    rng = np.random.default_rng(seed)
    stats = {}
    for k in range(n):
        cats = rng.choice(["dog", "cat", "man"], size=rng.integers(1, 3), replace=False)
        stats[f"i{k}.jpg"] = {
            "predict_caption": " ".join(cats),
            "true_captions": [" ".join(rng.choice(["a", "dog", "cat", "man", "on"], size=4))
                              for _ in range(2)],
            "beta": [(c, float(rng.random())) for c in cats],
            "lrp_mean": [(c, float(rng.random())) for c in cats],
            "attention_mean": [(c, float(rng.integers(0, 3)) / 2) for c in cats],   # ties
        }
    return stats


@pytest.mark.parametrize("seed", [0, 1])
def test_roc_aucs_equal_jax(seed):
    stats = _stats(seed)
    for got, ref in ((tw.beta_roc_auc(stats), jw.beta_roc_auc(stats)),
                     (tw.mean_roc_auc(stats, "lrp_mean"), jw.mean_roc_auc(stats, "lrp_mean")),
                     (tw.mean_roc_auc(stats, "attention_mean"),
                      jw.mean_roc_auc(stats, "attention_mean"))):
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-12)
        assert abs(got[2] - ref[2]) <= 1e-12


def test_word_stats_pickle_layout(tmp_path):
    """The port's dump is the reference's pickle layout: a plain dict that
    pickle.load and the JAX package's loader read back equal, and the port
    loads the JAX package's dump."""
    stats = _stats(2, n=4)
    tw.dump_word_stats(stats, str(tmp_path / "sub" / "t.pkl"))
    with open(tmp_path / "sub" / "t.pkl", "rb") as f:
        assert pickle.load(f) == stats
    assert jw.load_word_stats(str(tmp_path / "sub" / "t.pkl")) == stats
    jw.dump_word_stats(stats, str(tmp_path / "j.pkl"))
    assert tw.load_word_stats(str(tmp_path / "j.pkl")) == stats
    with open(tmp_path / "j.pkl", "rb") as fj, open(tmp_path / "sub" / "t.pkl", "rb") as ft:
        assert fj.read() == ft.read()


@pytest.mark.parametrize("pooling", ["max", "avg"])
@pytest.mark.parametrize("size, grid", [(224, 14), (32, 4), (30, 4)])
def test_pool_heatmap_to_grid_equals_jax(pooling, size, grid):
    hp = np.random.default_rng(size).normal(size=(size, size)).astype(np.float32)
    got = tw.pool_heatmap_to_grid(hp, grid, pooling)
    assert got.shape == (grid, grid)
    np.testing.assert_array_equal(got, jw.pool_heatmap_to_grid(hp, grid, pooling))


def test_pool_heatmap_to_grid_rejects_unknown_pooling():
    with pytest.raises(ValueError, match="pooling"):
        tw.pool_heatmap_to_grid(np.zeros((8, 8)), 4, "median")


def test_collect_word_stats_matches_jax(corpus, tmp_path):
    sides = torch_fixture.build(corpus)
    jex = JExplainer(sides["jax"]["cap"], sides["jax"]["params"],
                     sides["jax"]["provider"].caption_preprocessor, beam_size=3)
    tex = Explainer(sides["torch"]["cap"], sides["torch"]["params"],
                    sides["torch"]["provider"].caption_preprocessor, beam_size=3, device="cpu")
    test_set = sides["torch"]["dataset"].test_set
    # predictions holding category words, at positions inside and past the
    # decoded caption ("cat a green cat a green" for both test images)
    preds = {test_set[0].img_filename: "cat a green dog", test_set[1].img_filename: "a cat"}
    cats = ["cat", "green", "dog", "tree"]
    ref = jw.collect_word_stats(jex, sides["jax"]["provider"], preds, cats)
    got = tw.collect_word_stats(tex, sides["torch"]["provider"], preds, cats)
    assert got.keys() == ref.keys() == preds.keys()
    n_words = 0
    for fname, r in ref.items():
        g = got[fname]
        assert g["predict_caption"] == r["predict_caption"]
        assert g["true_captions"] == r["true_captions"]
        for key, tol in (("beta", 1e-5), ("lrp_mean", 1e-4), ("attention_mean", 1e-4)):
            assert [c for c, _ in g[key]] == [c for c, _ in r[key]]
            want = np.array([v for _, v in r[key]])
            have = np.array([v for _, v in g[key]])
            scale = 1.0 if key == "beta" else max(np.abs(want).max(), 1e-30)
            np.testing.assert_allclose(have, want, rtol=0, atol=tol * scale, err_msg=key)
        n_words += len(g["beta"])
    assert n_words >= 3
    tw.dump_word_stats(got, str(tmp_path / "stats.pkl"))
    assert os.path.getsize(tmp_path / "stats.pkl") > 0
    assert tw.collect_word_stats(tex, sides["torch"]["provider"], preds, cats, max_images=1).keys() \
        == {test_set[0].img_filename}
