"""Flickr30kEntities annotations -> ``filename -> {'categories', 'bbox',
'shape', 'resize_ratio'}`` (reference preparedataset.py:77-180).

The Flickr30k half of the JAX package's ``data/categories.py``, copied (pure
Python): ``data/minifixture.py`` writes the fixture's
``Flickr30kEntities.json`` through it. ``categories`` maps a phrase to its
id, ``bbox`` an id to [[xmin, ymin, xmax, ymax], ...] in the original
image's coordinates; ``resize_ratio`` = 224/width, 224/height. Sentences/*.txt
carry [/EN#<phrase_id>/<type> words...] chains, Annotations/*.xml are
VOC-style with <object><name>phrase_id</name><bndbox>. COCO's parser and
``load_entities_json`` come with ``evalx/bbox.py`` (ROADMAP A10c).
"""

from __future__ import annotations

import json
import os
import re
import xml.etree.ElementTree as ET


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
