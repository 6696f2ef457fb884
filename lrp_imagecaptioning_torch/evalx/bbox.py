"""Explanation correctness against ground-truth bounding boxes (host numpy).

The port's copy of the JAX package's ``evalx/bbox.py``: the reference's
evaluate_bbox.py:39-357 (EvaluationBboxCOCO[+Baseline]) and its aggregation
helpers (evaluate_bbox.py:673-919). Per test image: beam-search a caption,
match its words to the annotated categories (with the synonym table
CATEGORY_EXTENSION, evaluate_bbox.py:11-19), explain each word, and score
"correctness" = relevance mass inside the bbox / total mass at thresholds
0..0.9 (evaluate_bbox.py:191-208).

Heatmap processing reproduces the reference's negative-evidence variant
(evaluate_bbox.py:81): the relevance map is NEGATED, relu'd, channel-meaned
and projected before thresholding; ``negate=False`` scores the positive
variant the reference's comment describes. The Explainer does the device
work (one ``analyze_many`` a provider batch); the scoring runs on the host.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import torch

from ..explain.cnn_gradient import pyramid_expand

# word -> category synonym table (evaluate_bbox.py:11-19)
CATEGORY_EXTENSION = {
    "person": ["people", "woman", "women", "man", "men", "boy", "girl", "player", "baby", "person"],
    "airplane": ["plane", "jetliner", "jet", "airplane"],
    "bicycle": ["bike", "bicycle"],
    "car": ["car", "taxi"],
}
FILTER = ["a", "A", "an", "An", "the", "The", "'s"]

THRESHOLDS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]


def show_bbox(img_path: str, bboxes, title: str, ratio, out_path: str | None = None):
    """Draw scaled ground-truth boxes on the 224-resized image
    (show_bbox, evaluate_bbox.py:25-37); returns the PIL image."""
    from PIL import Image, ImageDraw

    img = Image.open(img_path).resize((224, 224))
    draw = ImageDraw.Draw(img)
    for bbox in bboxes:
        draw.rectangle(
            [bbox[0] * ratio[0], bbox[1] * ratio[1], bbox[2] * ratio[0], bbox[3] * ratio[1]],
            outline="black",
        )
        draw.text((bbox[0] * ratio[0], bbox[1] * ratio[1]), title)
    if out_path:
        img.save(out_path)
    return img


def correctness(bbox, relevance: np.ndarray, threshold: float) -> float:
    """Relevance mass inside bbox / total mass above threshold
    (_calculate_overlaped_pixels, evaluate_bbox.py:191-208).

    bbox: [xmin, ymin, xmax, ymax] in heatmap pixel coords."""
    rel = relevance.copy()
    rel[rel <= threshold] = 0
    total = rel.sum()
    if total == 0:
        return 0.0
    mask = np.zeros_like(rel)
    mask[int(bbox[1]): int(bbox[3]), int(bbox[0]): int(bbox[2])] = 1
    return float(min((mask * rel).sum() / total, 1.0))


def _project_pos(x: np.ndarray) -> np.ndarray:
    """x / max|x|; if negatives present shift to [0,1]
    (evaluate_bbox.py:60-70)."""
    absmax = np.max(np.abs(x))
    if absmax == 0:
        return np.zeros_like(x)
    x = x / absmax
    if (x < 0).sum():
        x = (x + 1) / 2
    return x


def process_heatmap(relevance_map: np.ndarray, negate: bool = True) -> np.ndarray:
    """(224,224,3) input relevance -> (224,224) score map
    (evaluate_bbox.py:74-86): BGR->RGB recode (channel-mean makes it moot),
    optional negation, relu, channel mean, project."""
    hm = relevance_map[..., ::-1]
    if negate:
        hm = -hm
    hm = np.maximum(hm, 0)
    hm = hm.mean(axis=-1)
    return _project_pos(hm)


def process_attention(attention: np.ndarray, grid: int = 14, upscale: int = 16) -> np.ndarray:
    """(L,) attention -> (224,224) projected map (pyramid_expand on the CPU)."""
    atn = torch.as_tensor(np.asarray(attention, np.float32)).reshape(grid, grid)
    return _project_pos(pyramid_expand(atn, upscale=upscale, sigma=20.0).numpy())


def match_words_to_categories(words: list[str], categories: dict):
    """caption words -> ({category_id: set((word_idx, word))}, {category_id:
    name}) (evaluate_bbox.py:222-236). ``categories`` maps category name -> id."""
    words_categories: dict = {}
    category_key: dict = {}
    for idx, word in enumerate(words):
        if word in FILTER:
            continue
        for name, cat_id in categories.items():
            hit = (name in CATEGORY_EXTENSION and word in CATEGORY_EXTENSION[name]) or (
                word in name.split()
            )
            if hit:
                words_categories.setdefault(cat_id, set()).add((idx, word))
                category_key[cat_id] = name
    return words_categories, category_key


class EvaluationBbox:
    """Per-image correctness scoring driven by an ``explain.engine.Explainer``."""

    def __init__(self, category_dict: dict, explainer, negate: bool = True):
        self._category_dict = category_dict
        self._explainer = explainer
        self._negate = negate
        cfg = explainer.captioner.cfg
        self._grid = int(round(float(np.sqrt(cfg.img_feature_length))))
        # model input resolution; the reference protocol is fixed at 224
        # (evaluate_bbox.py:74-86) and boxes in the entities dicts are
        # pre-scaled to it via resize_ratio = 224/original. When the model
        # runs at a smaller input (test configs), heatmaps come out at that
        # resolution and the 224-based boxes are rescaled onto it.
        size = getattr(cfg, "image_size", None)
        self._input_hw = tuple(size) if size else (224, 224)
        self._upscale = self._input_hw[0] // self._grid

    def evaluate(self, image, img_filename: str, explanation=None):
        """-> (lrp_scores, attention_scores, category_key) where scores are
        {category_id: {str(threshold): best correctness}}.

        Pass a precomputed ``explanation`` (e.g. from
        ``Explainer.analyze_many``) to skip the per-image dispatch."""
        ann = self._category_dict[img_filename]
        if explanation is None:
            explanation = self._explainer.analyze(image)
        words_categories, category_key = match_words_to_categories(
            explanation.words, ann["categories"]
        )
        ratio = ann["resize_ratio"]
        lrp_scores: dict = {}
        att_scores: dict = {}
        for cat_id, word_hits in words_categories.items():
            lrp_scores[cat_id] = {str(t): 0.0 for t in THRESHOLDS}
            att_scores[cat_id] = {str(t): 0.0 for t in THRESHOLDS}
            for word_idx, _ in word_hits:
                hm = process_heatmap(explanation.relevance_maps[word_idx], self._negate)
                atn = process_attention(explanation.attentions[word_idx], self._grid, self._upscale)
                for box in ann["bbox"][cat_id]:
                    # ratio maps original -> 224 (reference protocol); the
                    # extra map/224 factor maps 224 -> actual map resolution
                    # (identity at the reference's 224 inputs).
                    def scaled(m):
                        sx = ratio[0] * m.shape[1] / 224.0
                        sy = ratio[1] * m.shape[0] / 224.0
                        return [int(box[0] * sx), int(box[1] * sy),
                                int(box[2] * sx), int(box[3] * sy)]

                    box_hm, box_atn = scaled(hm), scaled(atn)
                    for t in THRESHOLDS:
                        lrp_scores[cat_id][str(t)] = max(
                            lrp_scores[cat_id][str(t)], correctness(box_hm, hm, t)
                        )
                        att_scores[cat_id][str(t)] = max(
                            att_scores[cat_id][str(t)], correctness(box_atn, atn, t)
                        )
        return lrp_scores, att_scores, category_key


def evaluate_dataset(explainer, provider, category_dict: dict, out_json: str,
                     negate: bool = True, max_images: int | None = None):
    """Driver: run EvaluationBbox over the test split, dump json
    (evaluate_coco_* equivalents, evaluate_bbox.py:360-671). The annotated
    images of each provider batch go to the card in one ``analyze_many`` at
    ``batch_size=provider.batch_size``."""
    ev = EvaluationBbox(category_dict, explainer, negate=negate)
    results = {}
    gen = provider.test_set(include_datum=True)
    n = 0
    for _ in range(provider.test_steps):
        (cap_in, imgs), y, data = next(gen)
        annotated = [(i, d) for i, d in enumerate(data) if d.img_filename in category_dict]
        if not annotated:
            continue
        batch = np.stack([imgs[i] for i, _ in annotated])
        explanations = explainer.analyze_many(batch, batch_size=provider.batch_size)
        for (i, datum), explanation in zip(annotated, explanations):
            lrp_s, att_s, keys = ev.evaluate(imgs[i], datum.img_filename, explanation=explanation)
            results[datum.img_filename] = {
                "lrp": {str(k): v for k, v in lrp_s.items()},
                "attention": {str(k): v for k, v in att_s.items()},
                "category_key": {str(k): v for k, v in keys.items()},
            }
            n += 1
            if max_images and n >= max_images:
                break
        if max_images and n >= max_images:
            break
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(results, f)
    return results


def analyze_results(results: dict, out_csv: str | None = None):
    """Aggregate per-threshold mean/std over all (image, category) scores
    (analyze_*_model equivalents, evaluate_bbox.py:673-919)."""
    agg = {}
    for kind in ("lrp", "attention"):
        per_t = {str(t): [] for t in THRESHOLDS}
        for img in results.values():
            for cat_scores in img[kind].values():
                for t, v in cat_scores.items():
                    per_t[t].append(v)
        agg[kind] = {
            t: {"mean": float(np.mean(v)) if v else 0.0, "std": float(np.std(v)) if v else 0.0}
            for t, v in per_t.items()
        }
    if out_csv:
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["kind", "threshold", "mean", "std"])
            for kind, rows in agg.items():
                for t, ms in rows.items():
                    w.writerow([kind, t, ms["mean"], ms["std"]])
    return agg
