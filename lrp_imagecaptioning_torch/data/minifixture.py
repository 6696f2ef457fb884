"""Mini-Flickr30k fixture generator — reference on-disk formats in miniature.

The port's own copy of the JAX package's ``data/minifixture.py``: it writes the
same files, byte for byte. PIL is imported where the JPEGs are drawn.

Writes a tiny but format-exact Flickr30k corpus so every pipeline stage can be
rehearsed end-to-end without the real (unavailable) data:

* ``Flickr30k_text/Flickr30k.token`` — ``<file>#<digit>\\t<caption>`` lines,
  the exact shape ``Flickr30kDataset`` splits on (reference
  preparedataset.py:420-474 reads the same file with the same regex).
* ``Flickr30k_text/Flickr_30k.{train,dev,test}Images.txt`` — split lists.
* ``Flickr30k_images/*.jpg`` — real JPEGs (tiny, procedurally drawn so the
  bbox fixtures below are geometrically meaningful: each image contains one
  solid-colour rectangle "object" on a contrasting background).
* ``Flickr30kEntities/Sentences/*.txt`` — ``[/EN#<id>/<type> phrase]`` chains
  (reference get_sentence_data, preparedataset.py:130-180).
* ``Flickr30kEntities/Annotations/*.xml`` — VOC-style bndbox annotations
  (reference get_annotations).
* ``Flickr30kEntities.json`` — the prebuilt entities artifact the reference
  ships (built here through ``Flickr30kCategory``, i.e. the parser itself is
  exercised while generating).
* ``instances_mini.json`` — a COCO detection-format twin of the same scenes,
  so ``COCOCategory`` can be rehearsed against identical geometry.

Captions intentionally include PTB-relevant surface forms (contractions,
hyphens, a trailing period) so the tokenizer path is exercised the way real
Flickr30k text would.
"""

from __future__ import annotations

import json
import os

from ..utils.io_utils import mkdir_p

# scene table: (stem, object word, colour word, bbox in ORIGINAL 64x48 coords)
# The drawn rectangle IS the bbox, so heatmap-vs-bbox correctness is a real
# geometric signal even at fixture scale.
_SCENES = [
    ("1000092795", "dog", "red", (8, 8, 28, 30)),
    ("1000268201", "cat", "blue", (30, 12, 54, 40)),
    ("1001773457", "ball", "green", (4, 20, 24, 44)),
    ("1003163366", "car", "yellow", (20, 4, 50, 24)),
    ("1007129816", "dog", "blue", (12, 16, 40, 42)),
    ("1007320043", "tree", "green", (36, 2, 60, 46)),
    ("1009434119", "cat", "red", (2, 2, 20, 20)),
    ("1012212859", "ball", "yellow", (26, 24, 52, 46)),
    ("1015118661", "car", "red", (6, 10, 34, 34)),
    ("1015584366", "tree", "blue", (40, 16, 62, 44)),
    ("1016887272", "dog", "green", (16, 6, 44, 28)),
    ("1019077836", "cat", "yellow", (10, 26, 36, 46)),
]

_COLOURS = {
    "red": (200, 40, 40),
    "blue": (40, 60, 200),
    "green": (40, 170, 60),
    "yellow": (220, 200, 40),
}

_W, _H = 64, 48  # original image size; deliberately non-square, non-224


def _captions(obj: str, colour: str) -> list[str]:
    """Five reference captions per image, with PTB-relevant surface forms."""
    return [
        f"A {colour} {obj} is sitting on the grass .",
        f"The {colour} {obj} doesn't move at all .",
        f"A close-up of a {colour} {obj} in mid-afternoon light .",
        f"There's a {colour} {obj} near the fence .",
        f"A {obj} , coloured {colour} , rests quietly .",
    ]


def _draw_image(path: str, colour: tuple, bbox: tuple) -> None:
    import numpy as np
    from PIL import Image

    arr = np.full((_H, _W, 3), 235, dtype="uint8")  # light background
    x0, y0, x1, y1 = bbox
    arr[y0:y1, x0:x1] = colour
    Image.fromarray(arr).save(path, format="JPEG", quality=90)


def write_mini_flickr30k(root: str) -> dict:
    """Generate the fixture under ``root``; returns a manifest dict.

    Layout matches ``FlickrConfig``'s defaults so
    ``FlickrConfig(dataset_root=root)`` loads it unmodified.
    """
    text_dir = os.path.join(root, "Flickr30k_text")
    img_dir = os.path.join(root, "Flickr30k_images")
    ent_dir = os.path.join(root, "Flickr30kEntities")
    sent_dir = os.path.join(ent_dir, "Sentences")
    ann_dir = os.path.join(ent_dir, "Annotations")
    for d in (text_dir, img_dir, sent_dir, ann_dir):
        mkdir_p(d)

    token_lines = []
    list_lines = []
    coco_images, coco_anns, coco_cats = [], [], {}
    for idx, (stem, obj, colour, bbox) in enumerate(_SCENES):
        fn = stem + ".jpg"
        list_lines.append(fn)
        _draw_image(os.path.join(img_dir, fn), _COLOURS[colour], bbox)
        caps = _captions(obj, colour)
        for ci, cap in enumerate(caps):
            token_lines.append(f"{fn}#{ci}\t{cap}")

        # Entities: phrase id unique per (image, phrase); the drawn rectangle
        # is the box for the "<colour> <obj>" phrase.
        pid = str(100 + idx)
        with open(os.path.join(sent_dir, stem + ".txt"), "w") as f:
            for cap in caps:
                marked = cap.replace(
                    f"{colour} {obj}", f"[/EN#{pid}/other {colour} {obj}]", 1)
                f.write(marked + "\n")
        x0, y0, x1, y1 = bbox
        with open(os.path.join(ann_dir, stem + ".xml"), "w") as f:
            f.write(
                "<annotation>"
                f"<filename>{fn}</filename>"
                f"<size><width>{_W}</width><height>{_H}</height>"
                "<depth>3</depth></size>"
                "<object>"
                f"<name>{pid}</name>"
                f"<bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
                f"<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox>"
                "</object>"
                "</annotation>"
            )

        # COCO-detection twin of the same scene
        if obj not in coco_cats:
            coco_cats[obj] = len(coco_cats) + 1
        coco_images.append(
            {"id": idx + 1, "file_name": fn, "width": _W, "height": _H})
        coco_anns.append({
            "id": idx + 1, "image_id": idx + 1,
            "category_id": coco_cats[obj],
            "bbox": [x0, y0, x1 - x0, y1 - y0],
        })

    with open(os.path.join(text_dir, "Flickr30k.token"), "w") as f:
        f.write("\n".join(token_lines) + "\n")
    # splits: 8 train / 2 dev / 2 test
    splits = {
        "Flickr_30k.trainImages.txt": list_lines[:8],
        "Flickr_30k.devImages.txt": list_lines[8:10],
        "Flickr_30k.testImages.txt": list_lines[10:],
    }
    for name, files in splits.items():
        with open(os.path.join(text_dir, name), "w") as f:
            f.write("\n".join(files) + "\n")
    with open(os.path.join(sent_dir, "list.txt"), "w") as f:
        f.write("\n".join(s + ".txt" for s, *_ in _SCENES) + "\n")

    with open(os.path.join(root, "instances_mini.json"), "w") as f:
        json.dump({
            "images": coco_images,
            "annotations": coco_anns,
            "categories": [
                {"id": cid, "name": name} for name, cid in coco_cats.items()
            ],
        }, f)

    # Build the prebuilt-entities artifact THROUGH the parser (exercises
    # Sentences/Annotations parsing at generation time).
    from .categories import Flickr30kCategory

    ents = Flickr30kCategory(
        ent_dir, out_json=os.path.join(root, "Flickr30kEntities.json"))

    return {
        "root": root,
        "n_images": len(_SCENES),
        "entities": len(ents.filename_to_category),
        "splits": {k: len(v) for k, v in splits.items()},
    }
