"""Ground-truth category and bbox annotations -> ``filename ->
{'categories', 'bbox', 'shape', 'resize_ratio'}`` dicts for ``evalx/bbox.py``
(reference preparedataset.py:18-235).

The port's copy of the JAX package's ``data/categories.py`` (pure Python).
``categories`` maps a name to its id, ``bbox`` an id to [[xmin, ymin, xmax,
ymax], ...] in the original image's coordinates; ``resize_ratio`` =
224/width, 224/height maps them onto the model input.

COCO: from an instances_*.json (COCO detection annotation format).
Flickr30k: from the Flickr30kEntities corpus: Sentences/*.txt carry
[/EN#<phrase_id>/<type> words...] chains, Annotations/*.xml are VOC-style
with <object><name>phrase_id</name><bndbox>. ``data/minifixture.py`` writes
the fixture's ``Flickr30kEntities.json`` through the latter.
"""

from __future__ import annotations

import json
import os
import re
import xml.etree.ElementTree as ET


def load_entities_json(path: str) -> dict:
    """Load a previously built entities json (COCOvalEntities.json /
    Flickr30kEntities.json, the artifacts the reference ships)."""
    with open(path) as f:
        return json.load(f)


class COCOCategory:
    """instances json -> filename_to_category (preparedataset.py:18-71)."""

    def __init__(self, file_path: str, out_json: str | None = None):
        with open(file_path) as f:
            dataset = json.load(f)
        id_to_file = {
            img["id"]: (img["file_name"], (img["width"], img["height"]))
            for img in dataset["images"]
        }
        cat_name = {c["id"]: c["name"] for c in dataset["categories"]}
        per_img_cats: dict = {}
        per_img_bbox: dict = {}
        for ann in dataset["annotations"]:
            img_id, cat_id = ann["image_id"], ann["category_id"]
            per_img_cats.setdefault(img_id, {})[cat_name[cat_id]] = str(cat_id)
            x, y, w, h = ann["bbox"]
            per_img_bbox.setdefault(img_id, {}).setdefault(str(cat_id), []).append(
                [x, y, x + w, y + h]
            )
        self.filename_to_category = {}
        for img_id, cats in per_img_cats.items():
            fname, shape = id_to_file[img_id]
            self.filename_to_category[fname] = {
                "categories": cats,
                "bbox": per_img_bbox[img_id],
                "shape": shape,
                "resize_ratio": (224.0 / shape[0], 224.0 / shape[1]),
            }
        if out_json:
            with open(out_json, "w") as f:
                json.dump(self.filename_to_category, f)


_PHRASE_RE = re.compile(r"\[/EN#(\d+)(?:/\S+)?\s([^\]]+)\]")


def parse_flickr_sentence(line: str) -> list[dict]:
    """One Flickr30kEntities sentence -> [{'phrase_id', 'phrase'}].

    (get_sentence_data equivalent, preparedataset.py:130-180)."""
    return [
        {"phrase_id": m.group(1), "phrase": m.group(2).strip().lower()}
        for m in _PHRASE_RE.finditer(line)
    ]


def parse_flickr_annotation_xml(path: str) -> dict:
    """VOC-style Annotations/*.xml -> {'width', 'height', 'boxes': {phrase_id:
    [[xmin,ymin,xmax,ymax], ...]}} (get_annotations equivalent)."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    out = {
        "width": int(size.find("width").text),
        "height": int(size.find("height").text),
        "boxes": {},
    }
    for obj in root.findall("object"):
        box = obj.find("bndbox")
        if box is None:
            continue
        coords = [
            int(float(box.find("xmin").text)), int(float(box.find("ymin").text)),
            int(float(box.find("xmax").text)), int(float(box.find("ymax").text)),
        ]
        for name in obj.findall("name"):
            out["boxes"].setdefault(name.text, []).append(coords)
    return out


class Flickr30kCategory:
    """Flickr30kEntities corpus -> filename_to_category
    (preparedataset.py:77-128)."""

    def __init__(self, root_path: str, out_json: str | None = None):
        sent_dir = os.path.join(root_path, "Sentences")
        ann_dir = os.path.join(root_path, "Annotations")
        with open(os.path.join(sent_dir, "list.txt")) as f:
            stems = [ln.strip().split(".")[0] for ln in f if ln.strip()]
        self.filename_to_category = {}
        for stem in stems:
            img_filename = stem + ".jpg"
            ann = parse_flickr_annotation_xml(os.path.join(ann_dir, stem + ".xml"))
            phrase_to_id = {}
            with open(os.path.join(sent_dir, stem + ".txt")) as f:
                for line in f:
                    for p in parse_flickr_sentence(line):
                        if p["phrase_id"] in ann["boxes"] and p["phrase"] not in phrase_to_id:
                            phrase_to_id[p["phrase"]] = p["phrase_id"]
            self.filename_to_category[img_filename] = {
                "categories": phrase_to_id,
                "bbox": ann["boxes"],
                "shape": (ann["width"], ann["height"]),
                "resize_ratio": (224.0 / ann["width"], 224.0 / ann["height"]),
            }
        if out_json:
            with open(out_json, "w") as f:
                json.dump(self.filename_to_category, f)
