"""Dataset parsers: Flickr30k, COCO2017, COCO2014-Karpathy, + synthetic.

The port's own copy of the JAX package's ``data/datasets.py``; PIL is
imported inside ``SyntheticDataset`` only, where it writes its images.

Equivalent of reference models/preparedataset.py:
* ``Datum`` == Data_format namedtuple (preparedataset.py:15)
* ``Flickr30kDataset`` parses Flickr30k.token lines split on '#<digit>\\t'
  (preparedataset.py:420-474): lowercased, trailing '.' stripped; one datum
  per caption for training, one per image (with all 5 refs) for val/test.
* ``COCODataset`` loads captions_train2017.json, sorted img ids sliced
  train_size/val_size; val2017 is the test split (preparedataset.py:285-353).
* ``COCODatasetKarpathy`` reads Karpathy dataset_coco.json splits
  (preparedataset.py:356-417).
* ``SyntheticDataset`` — new: deterministic toy data for tests/benchmarks.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass

from ..utils.io_utils import mkdir_p


@dataclass(frozen=True)
class Datum:
    img_filename: str
    img_path: str
    caption_txt: str
    all_captions_txt: tuple


class Dataset:
    """Base: result-dir management (preparedataset.py:238-282)."""

    DATASET_NAME = "base"

    def __init__(self, config, results_root: str = "results"):
        self.config = config
        self._results_root = results_root
        self.training_set: list[Datum] = []
        self.validation_set: list[Datum] = []
        self.test_set: list[Datum] = []

    @property
    def dataset_name(self):
        return self.DATASET_NAME

    @property
    def training_results_dir(self):
        d = os.path.join(self._results_root, self.DATASET_NAME, "training-results")
        mkdir_p(d)
        return d

    @property
    def training_set_size(self):
        return len(self.training_set)

    @property
    def validation_set_size(self):
        return len(self.validation_set)

    @property
    def test_set_size(self):
        return len(self.test_set)


def _clean_flickr_caption(cap: str) -> str:
    cap = cap.strip().lower()
    if cap.endswith("."):
        cap = cap[:-1].strip()
    return cap


class Flickr30kDataset(Dataset):
    """Flickr30k.token parser (preparedataset.py:420-474)."""

    DATASET_NAME = "flickr30k"

    def __init__(self, config, results_root: str = "results"):
        super().__init__(config, results_root)
        root = config.dataset_root
        token_file = os.path.join(root, config.caption_filename)
        img_dir = os.path.join(root, config.image_dir)

        captions: dict[str, list[str]] = {}
        with open(token_file, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                m = re.split(r"#\d+\t", line, maxsplit=1)
                if len(m) != 2:
                    continue
                fname, cap = m
                captions.setdefault(fname.strip(), []).append(_clean_flickr_caption(cap))

        def read_list(p):
            with open(os.path.join(root, p)) as f:
                return [l.strip() for l in f if l.strip()]

        train_files = read_list(config.train_image_list)
        dev_files = read_list(config.dev_image_list)
        test_files = read_list(config.test_image_list)

        # train: one datum per caption; val/test: one per image
        for fn in train_files:
            caps = tuple(captions.get(fn, ()))
            for cap in caps:
                self.training_set.append(Datum(fn, os.path.join(img_dir, fn), cap, caps))
        for fn in dev_files:
            caps = tuple(captions.get(fn, ()))
            if caps:
                self.validation_set.append(Datum(fn, os.path.join(img_dir, fn), caps[0], caps))
        for fn in test_files:
            caps = tuple(captions.get(fn, ()))
            if caps:
                self.test_set.append(Datum(fn, os.path.join(img_dir, fn), caps[0], caps))


class COCODataset(Dataset):
    """COCO2017: sorted train img-ids sliced train/val; val2017 = test
    (preparedataset.py:285-353)."""

    DATASET_NAME = "coco"

    def __init__(self, config, results_root: str = "results"):
        super().__init__(config, results_root)
        root = config.dataset_root

        def load(js, img_dir):
            with open(os.path.join(root, js)) as f:
                data = json.load(f)
            id_to_file = {im["id"]: im["file_name"] for im in data["images"]}
            caps: dict[int, list[str]] = {}
            for ann in data["annotations"]:
                caps.setdefault(ann["image_id"], []).append(_clean_flickr_caption(ann["caption"]))
            return id_to_file, caps, os.path.join(root, img_dir)

        id_to_file, caps, img_dir = load(config.train_caption_json, config.train_image_dir)
        img_ids = sorted(id_to_file)
        train_ids = img_ids[: config.train_size]
        val_ids = img_ids[config.train_size : config.train_size + config.val_size]

        for iid in train_ids:
            fn = id_to_file[iid]
            all_caps = tuple(caps.get(iid, ()))
            for cap in all_caps:
                self.training_set.append(Datum(fn, os.path.join(img_dir, fn), cap, all_caps))
        for iid in val_ids:
            fn = id_to_file[iid]
            all_caps = tuple(caps.get(iid, ()))
            if all_caps:
                self.validation_set.append(Datum(fn, os.path.join(img_dir, fn), all_caps[0], all_caps))

        vid_to_file, vcaps, vimg_dir = load(config.val_caption_json, config.val_image_dir)
        for iid in sorted(vid_to_file):
            fn = vid_to_file[iid]
            all_caps = tuple(vcaps.get(iid, ()))
            if all_caps:
                self.test_set.append(Datum(fn, os.path.join(vimg_dir, fn), all_caps[0], all_caps))


class COCODatasetKarpathy(Dataset):
    """Karpathy dataset_coco.json splits (preparedataset.py:356-417)."""

    DATASET_NAME = "coco2014"

    def __init__(self, config, results_root: str = "results"):
        super().__init__(config, results_root)
        root = config.dataset_root
        with open(os.path.join(root, config.karpathy_json)) as f:
            data = json.load(f)
        for im in data["images"]:
            fn = im["filename"]
            path = os.path.join(root, im.get("filepath", ""), fn)
            caps = tuple(_clean_flickr_caption(s["raw"]) for s in im["sentences"])
            split = im["split"]
            if split in ("train", "restval"):
                for cap in caps:
                    self.training_set.append(Datum(fn, path, cap, caps))
            elif split == "val":
                self.validation_set.append(Datum(fn, path, caps[0], caps))
            elif split == "test":
                self.test_set.append(Datum(fn, path, caps[0], caps))


class SyntheticDataset(Dataset):
    """Deterministic toy dataset for tests/benchmarks (no reference analog).

    Images are procedurally generated on first access and cached; captions are
    drawn from a tiny fixed grammar so vocabulary building is deterministic.
    """

    DATASET_NAME = "synthetic"

    _COLORS = ["red", "green", "blue", "yellow"]
    _OBJ = ["dog", "cat", "ball", "car", "tree"]
    _VERB = ["chases", "watches", "finds"]

    def __init__(self, config, n_train=64, n_val=8, n_test=8, results_root: str = "results", cache_dir=None):
        super().__init__(config, results_root)
        import numpy as np

        self._cache = cache_dir or os.path.join(tempfile.gettempdir(), "lrpic_synth")
        mkdir_p(self._cache)
        rng = np.random.default_rng(0)

        def make(i, split):
            fn = f"{split}_{i:04d}.png"
            path = os.path.join(self._cache, fn)
            if not os.path.exists(path):
                from PIL import Image

                arr = (rng.random((224, 224, 3)) * 255).astype("uint8")
                Image.fromarray(arr).save(path)
            c = self._COLORS[i % 4]
            o = self._OBJ[i % 5]
            v = self._VERB[i % 3]
            o2 = self._OBJ[(i + 2) % 5]
            caps = (f"a {c} {o} {v} a {o2}", f"the {c} {o} {v} the {o2}")
            return Datum(fn, path, caps[0], caps)

        self.training_set = [make(i, "train") for i in range(n_train)]
        self.validation_set = [make(i, "val") for i in range(n_val)]
        self.test_set = [make(i, "test") for i in range(n_test)]
