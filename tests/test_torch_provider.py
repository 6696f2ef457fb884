"""PyTorch port: the data layer (dataset parsers, the mini-Flickr30k fixture,
DatasetProvider, the native loader's binding) against the JAX package.

Everything here is numpy and files, so every comparison is exact: parsed
datum lists equal, fixture files byte-equal, batches ``np.array_equal``.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from lrp_imagecaptioning_tpu import config as jconfig  # noqa: E402
from lrp_imagecaptioning_tpu.data import datasets as jdatasets  # noqa: E402
from lrp_imagecaptioning_tpu.data.minifixture import write_mini_flickr30k as j_write  # noqa: E402
from lrp_imagecaptioning_tpu.data.provider import DatasetProvider as JProvider  # noqa: E402
from lrp_imagecaptioning_torch import config as tconfig  # noqa: E402
from lrp_imagecaptioning_torch.data import datasets as tdatasets  # noqa: E402
from lrp_imagecaptioning_torch.data import loader_native  # noqa: E402
from lrp_imagecaptioning_torch.data.images import ImagePreprocessor  # noqa: E402
from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k as t_write  # noqa: E402
from lrp_imagecaptioning_torch.data.provider import DatasetProvider as TProvider  # noqa: E402


def _write_flickr(root):
    (root / "Flickr30k_text").mkdir(parents=True)
    (root / "Flickr30k_text" / "Flickr30k.token").write_text(
        "1.jpg#0\tA dog Runs fast .\n1.jpg#1\tthe dog is running\n2.jpg#0\tA cat sits.\n"
        "3.jpg#0\tsomething else\n")
    (root / "Flickr30k_text" / "Flickr_30k.trainImages.txt").write_text("1.jpg\n")
    (root / "Flickr30k_text" / "Flickr_30k.devImages.txt").write_text("2.jpg\n")
    (root / "Flickr30k_text" / "Flickr_30k.testImages.txt").write_text("3.jpg\n")
    return {"dataset_root": str(root)}


def _write_coco(root):
    (root / "annotations").mkdir(parents=True)

    def js(ids, extra_for=None):
        anns = [{"image_id": i, "caption": f"Caption number {i}."} for i in ids]
        if extra_for is not None:
            anns.append({"image_id": extra_for, "caption": "second caption"})
        return {"images": [{"id": i, "file_name": f"{i:04d}.jpg"} for i in ids],
                "annotations": anns}

    (root / "annotations" / "captions_train2017.json").write_text(
        json.dumps(js([3, 1, 2], extra_for=1)))
    (root / "annotations" / "captions_val2017.json").write_text(json.dumps(js([9])))
    return {"dataset_root": str(root), "train_size": 2, "val_size": 1}


def _write_karpathy(root):
    root.mkdir()
    data = {"images": [
        {"filename": "a.jpg", "filepath": "train2014", "split": "train",
         "sentences": [{"raw": "One."}, {"raw": "Two"}]},
        {"filename": "b.jpg", "filepath": "train2014", "split": "restval",
         "sentences": [{"raw": "Three"}]},
        {"filename": "c.jpg", "filepath": "val2014", "split": "val",
         "sentences": [{"raw": "Four"}]},
        {"filename": "d.jpg", "filepath": "val2014", "split": "test",
         "sentences": [{"raw": "Five"}]},
    ]}
    (root / "dataset_coco.json").write_text(json.dumps(data))
    return {"dataset_root": str(root)}


# (config class, dataset class, fixture writer, the splits' sizes as
# tests/test_datasets.py pins them)
PARSERS = {
    "flickr30k": ("FlickrConfig", "Flickr30kDataset", _write_flickr, (2, 1, 1)),
    "coco": ("COCOConfig", "COCODataset", _write_coco, (3, 1, 1)),
    "karpathy": ("COCO2014Config", "COCODatasetKarpathy", _write_karpathy, (3, 1, 1)),
}


@pytest.mark.parametrize("name", list(PARSERS))
def test_dataset_parsing_matches_jax(name, tmp_path):
    cfg_name, ds_name, write, sizes = PARSERS[name]
    kw = write(tmp_path / "ds")
    got = getattr(tdatasets, ds_name)(getattr(tconfig, cfg_name)(**kw),
                                      results_root=str(tmp_path / "r"))
    want = getattr(jdatasets, ds_name)(getattr(jconfig, cfg_name)(**kw),
                                       results_root=str(tmp_path / "r"))
    assert got.dataset_name == want.dataset_name
    for split in ("training_set", "validation_set", "test_set"):
        assert [tuple(vars(d).values()) for d in getattr(got, split)] == \
            [tuple(vars(d).values()) for d in getattr(want, split)]
    assert (got.training_set_size, got.validation_set_size, got.test_set_size) == sizes
    if name == "flickr30k":
        assert got.training_set[0].caption_txt == "a dog runs fast"
        assert got.training_set[0].all_captions_txt == ("a dog runs fast", "the dog is running")
    if name == "karpathy":
        assert got.test_set[0].img_path.endswith(os.path.join("val2014", "d.jpg"))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def fixture_roots(tmp_path_factory):
    """The mini-Flickr30k written by the port and by the JAX package."""
    t_root = str(tmp_path_factory.mktemp("torch_mini"))
    j_root = str(tmp_path_factory.mktemp("jax_mini"))
    t_manifest, j_manifest = t_write(t_root), j_write(j_root)
    return t_root, j_root, t_manifest, j_manifest


def test_minifixture_files_byte_equal(fixture_roots):
    t_root, j_root, t_manifest, j_manifest = fixture_roots
    got, want = _files(t_root), _files(j_root)
    assert sorted(got) == sorted(want)
    assert len(got) == 12 + 12 + 12 + 1 + 4 + 1 + 1   # jpgs, xmls, txts, list, 4 text, 2 json
    for rel in want:
        assert got[rel] == want[rel], rel
    assert {k: v for k, v in t_manifest.items() if k != "root"} == \
        {k: v for k, v in j_manifest.items() if k != "root"}


def _providers(root, single_caption=False, **over):
    kw = dict(dataset_root=root, batch_size=3, rare_words_handling="nothing",
              words_min_occur=1, image_size=(32, 32), **over)
    tcfg, jcfg = tconfig.FlickrConfig(**kw), jconfig.FlickrConfig(**kw)
    tp = TProvider(tdatasets.Flickr30kDataset(tcfg), tcfg, single_caption=single_caption)
    jp = JProvider(jdatasets.Flickr30kDataset(jcfg), jcfg, single_caption=single_caption)
    return tp, jp


def _assert_batches_equal(got, want):
    (g_cap, g_img), g_y = got[:2]
    (w_cap, w_img), w_y = want[:2]
    for g, w in ((g_cap, w_cap), (g_img, w_img), (g_y, w_y)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    if len(want) == 3:   # the datums: the port's own dataclass, the same fields
        assert [tuple(vars(d).values()) for d in got[2]] == \
            [tuple(vars(d).values()) for d in want[2]]


# (generator, its keyword arguments, provider options): 15 batches of each,
# past an epoch's end (8 train images x 5 captions = 40 data, batch 3)
BATCH_CASES = {
    "train": ("training_set", {}, {}),
    "train-pad": ("training_set", {"pad_to_length": 21}, {}),
    "train-skip": ("training_set", {"pad_to_length": 21, "skip_batches": 12}, {}),
    "train-drop-remainder": ("training_set", {"drop_remainder": True}, {}),
    "train-single-caption": ("training_set", {"pad_to_length": 21}, {"single_caption": True}),
    "train-augmented": ("training_set", {}, {"image_augmentation": True}),
    "validation-datum": ("validation_set", {"include_datum": True, "pad_to_length": 21}, {}),
    "test-datum": ("test_set", {"include_datum": True}, {}),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_provider_batches_equal_jax(case, fixture_roots):
    gen_name, gen_kw, opts = BATCH_CASES[case]
    tp, jp = _providers(fixture_roots[0], **opts)
    assert tp.vocabs == jp.vocabs and tp.vocab_size == jp.vocab_size
    assert (tp.training_steps, tp.validation_steps, tp.test_steps) == \
        (jp.training_steps, jp.validation_steps, jp.test_steps)
    tg, jg = getattr(tp, gen_name)(**gen_kw), getattr(jp, gen_name)(**gen_kw)
    sizes = []
    for _ in range(15):
        got, want = next(tg), next(jg)
        _assert_batches_equal(got, want)
        sizes.append(got[0][1].shape[0])
    if case == "train-drop-remainder":
        assert set(sizes) == {3}
    elif gen_name == "training_set":
        assert 1 in sizes   # the epoch's short tail: 40 = 13 x 3 + 1


def test_skip_batches_are_not_preprocessed(fixture_roots, monkeypatch):
    tp, _ = _providers(fixture_roots[0])
    calls = []
    orig = tp.image_preprocessor.preprocess_batch_paths

    def counting(paths, rt):
        calls.append(len(paths))
        return orig(paths, rt)

    monkeypatch.setattr(tp.image_preprocessor, "preprocess_batch_paths", counting)
    next(tp.training_set(skip_batches=5))
    assert len(calls) == 1


def test_native_loader_matches_python_path(fixture_roots):
    """The ctypes binding over native/libimgloader.so against the PIL path on
    the fixture's JPEGs, within the JAX package's bounds for JPEG
    (tests/test_native_loader.py: decoders may round the DCT by a few 8-bit
    levels); skipped where the library is not built."""
    if not loader_native.available():
        pytest.skip("native/libimgloader.so is not built (make -C native)")
    root = fixture_roots[0]
    paths = sorted(os.path.join(root, "Flickr30k_images", n)
                   for n in os.listdir(os.path.join(root, "Flickr30k_images")))[:4]
    pp = ImagePreprocessor(image_size=(32, 32))
    got = loader_native.load_batch(paths, 32, "caffe")
    want = np.asarray(pp.preprocess_images(paths), np.float32)
    assert got.shape == want.shape == (4, 32, 32, 3)
    assert np.abs(got - want).max() <= 4.0
    assert (np.abs(got - want) > 0.5).mean() < 0.05
    # the provider's entry point takes the native loader at a square size
    np.testing.assert_array_equal(pp.preprocess_batch_paths(paths), got)
    # and the PIL path with augmentation or a non-square size
    np.testing.assert_array_equal(
        ImagePreprocessor(image_size=(32, 24)).preprocess_batch_paths(paths),
        np.asarray(ImagePreprocessor(image_size=(32, 24)).preprocess_images(paths), np.float32))
    with pytest.raises(RuntimeError, match="1-th"):
        loader_native.load_batch([paths[0], os.path.join(root, "missing.jpg")], 32)
