"""PyTorch port: bbox correctness (``evalx/bbox.py``) and the COCO parser
(``data/categories.py``) against the JAX package.

The host-side helpers take the same numpy inputs on both sides and must give
equal results. The one exception is the attention map: both sides upscale it
with their own ``pyramid_expand`` (an interpolation and a Gaussian blur in
f32, summed in another order), under 1e-6 apart, so attention scores are held to
1e-6 where the relevance scores, all numpy, are held equal. End to end,
``evaluate_dataset`` on the mini-Flickr30k fixture (its
``Flickr30kEntities.json``, and ``instances_mini.json`` through
``COCOCategory``) runs each package's Explainer on the same params: captions
equal, every score within 1e-3.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_fixture  # noqa: E402
from lrp_imagecaptioning_tpu.data import categories as jcat  # noqa: E402
from lrp_imagecaptioning_tpu.evalx import bbox as jb  # noqa: E402
from lrp_imagecaptioning_tpu.explain.engine import Explainer as JExplainer  # noqa: E402
from lrp_imagecaptioning_torch.data import categories as tcat  # noqa: E402
from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k  # noqa: E402
from lrp_imagecaptioning_torch.evalx import bbox as tb  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer, Explanation  # noqa: E402

torch.set_num_threads(2)

ATT_TOL = 1e-6      # the two pyramid_expands' f32 rounding
SCORE_TOL = 1e-3    # end to end: maps from two Explainers within 1e-4 of scale


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini30k"))
    write_mini_flickr30k(root)
    return root


@pytest.mark.parametrize("words, cats", [
    (["a", "man", "with", "his", "dog"], {"person": "1", "dog": "18"}),
    (["the", "jet", "and", "a", "bike"], {"airplane": "5", "bicycle": "2", "car": "3"}),
    (["a", "green", "dog", "green"], {"green dog": "110", "red cat": "106"}),
    (["a", "the", "'s"], {"a thing": "9"}),
])
def test_match_words_to_categories_equals_jax(words, cats):
    assert tb.match_words_to_categories(words, cats) == jb.match_words_to_categories(words, cats)


@pytest.mark.parametrize("negate", [True, False])
@pytest.mark.parametrize("kind", ["signed", "positive", "zero"])
def test_process_heatmap_equals_jax(negate, kind):
    rng = np.random.default_rng(1)
    m = rng.normal(size=(32, 32, 3)).astype(np.float32)
    m = {"signed": m, "positive": np.abs(m), "zero": np.zeros_like(m)}[kind]
    np.testing.assert_array_equal(tb.process_heatmap(m, negate), jb.process_heatmap(m, negate))


@pytest.mark.parametrize("grid, upscale", [(14, 16), (8, 4)])
def test_process_attention_matches_jax(grid, upscale):
    a = np.random.default_rng(grid).random(grid * grid).astype(np.float32)
    got, ref = tb.process_attention(a / a.sum(), grid, upscale), jb.process_attention(
        a / a.sum(), grid, upscale)
    assert got.shape == ref.shape == (grid * upscale,) * 2
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATT_TOL)


@pytest.mark.parametrize("box", [[2, 3, 20, 17], [0, 0, 32, 32], [5, 5, 5, 9], [30, 1, 90, 40]])
def test_correctness_equals_jax(box):
    rel = np.abs(np.random.default_rng(2).normal(size=(32, 32)))
    rel /= rel.max()
    for t in tb.THRESHOLDS:
        assert tb.correctness(box, rel, t) == jb.correctness(box, rel, t)
    assert tb.correctness(box, np.zeros((32, 32)), 0.0) == 0.0


def test_show_bbox_draws_as_jax(tmp_path):
    from PIL import Image

    arr = (np.random.default_rng(3).random((300, 400, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "img.png")
    Image.fromarray(arr).save(p)
    imgs = []
    for side, fn in (("jax", jb.show_bbox), ("torch", tb.show_bbox)):
        out = str(tmp_path / f"{side}.png")
        img = fn(p, [[10, 10, 100, 80], [50, 60, 300, 250]], "person", (224 / 400, 224 / 300),
                 out_path=out)
        assert img.size == (224, 224) and os.path.getsize(out) > 0
        imgs.append(np.asarray(Image.open(out)))
    np.testing.assert_array_equal(*imgs)


class _StubExplainer:
    """The surface EvaluationBbox reads: the captioner's config."""

    def __init__(self, cfg):
        self.captioner = type("Cap", (), {"cfg": cfg})()


@pytest.mark.parametrize("negate", [True, False])
def test_evaluation_bbox_same_explanation_equals_jax(negate):
    """Both EvaluationBbox's on one Explanation's arrays: the same categories,
    equal relevance scores, attention scores within ATT_TOL."""
    rng = np.random.default_rng(4)
    words = ["a", "green", "dog", "and", "a", "cat"]
    W = len(words)
    e = Explanation(caption=" ".join(words + ["zeros"]), words=words,
                    tokens_1based=np.zeros(6, np.int32),
                    relevance_maps=rng.normal(size=(W, 32, 32, 3)).astype(np.float32),
                    feat_relevance=np.zeros((W, 64, 256), np.float32),
                    attentions=rng.dirichlet(np.ones(64), size=W).astype(np.float32),
                    word_relevances=np.zeros((W, 6), np.float32),
                    betas=rng.random(W).astype(np.float32))
    ann = {"img.jpg": {"categories": {"green dog": "110", "cat": "2", "tree": "5"},
                       "bbox": {"110": [[8, 8, 28, 30], [40, 2, 60, 20]], "2": [[10, 26, 36, 46]],
                                "5": [[0, 0, 5, 5]]},
                       "resize_ratio": [3.5, 4.666666666666667]}}
    out = {}
    for side, mod, Config in (("jax", jb, torch_fixture.JConfig),
                              ("torch", tb, torch_fixture.TConfig)):
        ev = mod.EvaluationBbox(ann, _StubExplainer(Config(**torch_fixture.SMALL)), negate=negate)
        out[side] = ev.evaluate(None, "img.jpg", explanation=e)
    (lrp_t, att_t, key_t), (lrp_j, att_j, key_j) = out["torch"], out["jax"]
    assert key_t == key_j == {"110": "green dog", "2": "cat"}
    assert lrp_t == lrp_j
    assert att_t.keys() == att_j.keys()
    for cat in att_j:
        assert att_t[cat].keys() == att_j[cat].keys()
        for t, v in att_j[cat].items():
            assert abs(att_t[cat][t] - v) <= ATT_TOL
    assert any(v > 0 for s in lrp_t.values() for v in s.values())


def _explainers(sides, method="lrp"):
    jex = JExplainer(sides["jax"]["cap"], sides["jax"]["params"],
                     sides["jax"]["provider"].caption_preprocessor, method=method, beam_size=3)
    tex = Explainer(sides["torch"]["cap"], sides["torch"]["params"],
                    sides["torch"]["provider"].caption_preprocessor, method=method, beam_size=3,
                    device="cpu")
    return jex, tex


def _assert_scores_close(got, ref, tol=SCORE_TOL):
    assert got.keys() == ref.keys()
    for img, r in ref.items():
        g = got[img]
        assert g["category_key"] == r["category_key"]
        for kind in ("lrp", "attention"):
            assert g[kind].keys() == r[kind].keys()
            for cat, scores in r[kind].items():
                for t, v in scores.items():
                    assert abs(g[kind][cat][t] - v) <= tol, (img, kind, cat, t)


@pytest.mark.parametrize("entities", ["flickr30k", "coco"])
def test_evaluate_dataset_matches_jax(corpus, tmp_path, entities):
    sides = torch_fixture.build(corpus)
    if entities == "flickr30k":
        path = os.path.join(corpus, "Flickr30kEntities.json")
        cat_j, cat_t = jcat.load_entities_json(path), tcat.load_entities_json(path)
    else:
        path = os.path.join(corpus, "instances_mini.json")
        cat_j = jcat.COCOCategory(path).filename_to_category
        cat_t = tcat.COCOCategory(path, out_json=str(tmp_path / "coco.json")).filename_to_category
        assert tcat.load_entities_json(str(tmp_path / "coco.json")) == \
            _json_roundtrip(cat_j)
    assert cat_t == cat_j
    jex, tex = _explainers(sides)
    # the captions each Explainer decodes for the test split: equal
    imgs = np.stack([sides["torch"]["provider"].image_preprocessor.preprocess_batch_paths(
        [d.img_path])[0] for d in sides["torch"]["dataset"].test_set])
    caps_t = [tex.predict_caption(i)[1] for i in imgs]
    assert caps_t == [jex.predict_caption(jnp.asarray(i))[1] for i in imgs]
    ref = jb.evaluate_dataset(jex, sides["jax"]["provider"], cat_j, str(tmp_path / "j.json"))
    got = tb.evaluate_dataset(tex, sides["torch"]["provider"], cat_t, str(tmp_path / "t.json"))
    # "cat a green cat a green": green dog and yellow cat; COCO's cat only
    scored = {"flickr30k": 2, "coco": 1}[entities]
    assert len(got) == 2 and sum(len(r["lrp"]) for r in got.values()) == scored, got
    _assert_scores_close(got, ref)
    _assert_scores_close(tcat.load_entities_json(str(tmp_path / "t.json")), ref)
    # the aggregate, and its CSV, from one results dict on both sides
    agg_t = tb.analyze_results(ref, out_csv=str(tmp_path / "t.csv"))
    agg_j = jb.analyze_results(ref, out_csv=str(tmp_path / "j.csv"))
    assert agg_t == agg_j
    with open(tmp_path / "t.csv") as ft, open(tmp_path / "j.csv") as fj:
        assert ft.read() == fj.read()


def _json_roundtrip(d):
    """A dict as json.load gives it back (tuples become lists)."""
    import json

    return json.loads(json.dumps(d))


def test_evaluate_dataset_max_images(corpus, tmp_path):
    sides = torch_fixture.build(corpus)
    _, tex = _explainers(sides)
    cats = tcat.load_entities_json(os.path.join(corpus, "Flickr30kEntities.json"))
    got = tb.evaluate_dataset(tex, sides["torch"]["provider"], cats, str(tmp_path / "o/r.json"),
                              max_images=1)
    assert len(got) == 1 and os.path.exists(tmp_path / "o/r.json")
