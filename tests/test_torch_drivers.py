"""PyTorch port: the explanation drivers (``explain/drivers.py``) and the
heatmap helpers (``utils/visualizations.py``) against the JAX package.

The visualisation helpers are host numpy on both sides and must give equal
arrays. The drivers run each package's Explainer on the mini-Flickr30k
fixture with the same params: captions equal, every Explanation array within
1e-4 of its scale (as tests/test_torch_explainer.py), and the reference's
three figure files written for each image.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")
import jax  # noqa: E402

import torch_fixture  # noqa: E402
from lrp_imagecaptioning_tpu.explain import drivers as jd  # noqa: E402
from lrp_imagecaptioning_tpu.train.checkpoint import save_params_npz  # noqa: E402
from lrp_imagecaptioning_tpu.utils import visualizations as jv  # noqa: E402
from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k  # noqa: E402
from lrp_imagecaptioning_torch.explain import drivers as td  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explanation  # noqa: E402
from lrp_imagecaptioning_torch.utils import visualizations as tv  # noqa: E402

torch.set_num_threads(2)

MAP_RTOL = 1e-4
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini30k"))
    write_mini_flickr30k(root)
    return root


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max() if ref.size else 0.0
    return 0.0 if scale == 0 else float(np.abs(got - ref).max() / scale)


def _assert_same(got, ref):
    assert got.words == ref.words and got.caption == ref.caption
    np.testing.assert_array_equal(got.tokens_1based, np.asarray(ref.tokens_1based))
    for name in FIELDS:
        assert _rel(getattr(got, name), getattr(ref, name)) <= MAP_RTOL, name


def _figures(folder, stem, method):
    return sorted(os.listdir(folder)) == sorted([f"{stem}.jpg", f"{stem}{method}_hm.jpg",
                                                 f"{stem}attention.jpg"])


@pytest.mark.parametrize("name, args, kw", [
    ("postprocess", (), dict(color_coding="BGRtoRGB")),
    ("postprocess", (), dict(channels_first=True)),
    ("project", (), {}),
    ("project", (), dict(input_is_positive_only=True, output_range=(-2, 3))),
    ("heatmap", (), {}),
    ("heatmap", (), dict(cmap_type="viridis")),
    ("graymap", (), {}),
    ("gamma", (), dict(gamma_value=0.3, minamp=0.1)),
    ("clip_quantile", (), dict(quantile=5.0)),
])
def test_visualizations_equal_jax(name, args, kw):
    x = np.random.default_rng(0).normal(size=(2, 6, 5, 3)).astype(np.float32)
    x[1] = 0.0                          # a zero sample: project's absmax guard
    got = getattr(tv, name)(x, *args, **kw)
    ref = getattr(jv, name)(x, *args, **kw)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_array_equal(got, ref)


def test_word_grid_equals_jax():
    for n in (1, 2, 5, 9, 10, 20):
        assert td._word_grid(n) == jd._word_grid(n)


def test_render_explanation_writes_three_files(tmp_path):
    rng = np.random.default_rng(1)
    W = 3
    e = Explanation(caption="a b c zeros", words=["a", "b", "c"],
                    tokens_1based=np.zeros(6, np.int32),
                    relevance_maps=rng.normal(size=(W, 32, 32, 3)).astype(np.float32),
                    feat_relevance=np.zeros((W, 64, 256), np.float32),
                    attentions=rng.random((W, 64)).astype(np.float32),
                    word_relevances=np.zeros((W, 6), np.float32), betas=np.zeros(W, np.float32))
    raw = rng.random((32, 32, 3)) * 255
    written = td.render_explanation(e, raw, str(tmp_path / "img"), "img.jpg", method="lrp",
                                    grid=8, upscale=4)
    assert [os.path.basename(p) for p in written] == ["img.jpg", "imglrp_hm.jpg",
                                                      "imgattention.jpg"]
    assert all(os.path.getsize(p) > 0 for p in written)


@pytest.mark.parametrize("method", ["lrp", "deep_taylor"])
def test_explain_image_file_matches_jax(corpus, tmp_path, method):
    sides = torch_fixture.build(corpus)
    img = os.path.join(corpus, "Flickr30k_images", "1016887272.jpg")
    out = {}
    for side, fn, kw in (("jax", jd.explain_image_file, {}),
                         ("torch", td.explain_image_file, dict(device="cpu"))):
        s = sides[side]
        out[side] = fn(s["cap"], s["params"], s["provider"].caption_preprocessor, img,
                       str(tmp_path / side), method=method, beam_size=3, **kw)
        assert _figures(str(tmp_path / side / "1016887272"), "1016887272", method)
    _assert_same(out["torch"], out["jax"])
    assert out["torch"].words


def test_process_beam_search_matches_jax(corpus, tmp_path):
    sides = torch_fixture.build(corpus, "gridTD")
    got = td.process_beam_search(sides["torch"]["cap"], sides["torch"]["params"],
                                 sides["torch"]["provider"], str(tmp_path / "t"), num_images=2,
                                 device="cpu")
    ref = jd.process_beam_search(sides["jax"]["cap"], sides["jax"]["params"],
                                 sides["jax"]["provider"], str(tmp_path / "j"), num_images=2)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _assert_same(g, r)
    for d in sides["torch"]["dataset"].test_set:
        stem = d.img_filename.split(".")[0]
        assert _figures(str(tmp_path / "t" / stem), stem, "lrp")


def test_explain_flickr30k_model_reads_npz(corpus, tmp_path):
    """The dataset drivers read the JAX package's flat params npz, and raise
    for an orbax directory (its save_params_npz converts one)."""
    sides = torch_fixture.build(corpus)
    npz = str(tmp_path / "w.npz")
    save_params_npz(npz, jax.tree.map(np.asarray, sides["jax"]["params"]))
    s = sides["torch"]
    got = td.explain_flickr30k_model(s["cfg"], s["dataset"], npz, "adaptiveattention",
                                     out_dir=str(tmp_path / "out"), device="cpu")
    ref = jd.process_beam_search(sides["jax"]["cap"], sides["jax"]["params"],
                                 sides["jax"]["provider"], str(tmp_path / "j"))
    _assert_same(got[0], ref[0])
    with pytest.raises(ValueError, match="save_params_npz"):
        td.explain_coco_model(s["cfg"], s["dataset"], str(tmp_path / "orbax_dir"),
                              "adaptiveattention", device="cpu")
