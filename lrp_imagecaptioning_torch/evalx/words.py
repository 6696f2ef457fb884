"""Word-level explanation analysis: frequent-object mAP and explanation-score
ROC-AUC (object-hallucination metrics), on the host.

The port's copy of the JAX package's ``evalx/words.py``: the reference's
exaimin_word.py: the category word lists (exaimin_word.py:10-24),
``analyze_predicted_captions`` mAP (exaimin_word.py:315-367), the per-word
stat collectors (beta / mean-LRP / mean-attention, exaimin_word.py:371-460)
and the ROC-AUC analyses (exaimin_word.py:623-746). The ROC curve and its
trapezoid AUC are computed in numpy, as ``sklearn.metrics.roc_curve`` (with
its default ``drop_intermediate``) and ``auc`` compute them: the card's host
has no scikit-learn.
"""

from __future__ import annotations

import numpy as np
import torch

from ..explain.cnn_gradient import pyramid_expand

# exaimin_word.py:10-24 — dataset category word lists
FLICKR_CATEGORY = ["people", "man", "boy", "girl", "dog", "jacket", "shirt", "hat",
                   "dress", "ball", "bicycle", "microphone"]
COCO_CATEGORY = ["bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat",
                 "bench", "bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear",
                 "zebra", "giraffe", "backpack", "hat", "umbrella", "handbag", "tie", "suitcase",
                 "frisbee", "skis", "snowboard", "kite", "skateboard", "surfboard", "bottle",
                 "cup", "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
                 "broccoli", "carrot", "pizza", "donut", "cake", "chair", "couch", "bed", "toilet",
                 "tv", "laptop", "mouse", "remote", "keyboard", "microwave", "oven", "toaster",
                 "sink", "refrigerator", "book", "clock", "vase", "scissors", "toothbrush",
                 "ball", "bat", "glove", "racket", "hydrant", "glass", "drier", "table", "phone"]
FREQUENT_OBJECT = ["man", "shirt", "woman", "people", "group", "street", "dog", "bench", "boy"]
COCO_FREQUENT_OBJECT = ["man", "group", "people", "street", "table", "woman", "plate", "tennis",
                        "food", "train", "person", "road", "sink", "building", "cat", "bathroom",
                        "snow", "baseball", "bench", "clock", "dog", "toilet", "laptop", "bus",
                        "computer", "beach", "court", "skateboard", "surfboard", "desk", "bed"]


def frequent_object_map(id_to_prediction: dict, id_to_references: dict,
                        category_list: list[str]) -> float:
    """mAP over frequent object words (analyze_predicted_captions,
    exaimin_word.py:315-367): per category, AP = (#images where the word is in
    BOTH prediction and some reference) / (#images where it is in a
    reference); mAP normalizes by len(categories)-1 x100 — reproducing the
    reference's divisor quirk (exaimin_word.py:365)."""
    count_cat = {c: 0 for c in category_list}
    tp = {c: 0.0 for c in category_list}
    for category in category_list:
        for img_id, refs in id_to_references.items():
            if img_id not in id_to_prediction:
                continue
            pred_words = id_to_prediction[img_id].split()
            in_ref = any(category in r.split() for r in refs)
            if in_ref:
                count_cat[category] += 1
                if category in pred_words:
                    tp[category] += 1
    total = 0.0
    for c in category_list:
        if count_cat[c]:
            total += tp[c] / count_cat[c]
    return total / max(len(category_list) - 1, 1) * 100.0


def word_index_in_caption(caption: str, category: str) -> int | None:
    """First position of the category word (get_index, exaimin_word.py:372-377;
    returned 0-based here — the reference's +1 was its 1-based state index)."""
    for t, w in enumerate(caption.split(" ")):
        if w == category:
            return t
    return None


def collect_word_stats(explainer, provider, id_to_prediction: dict, category_list: list[str],
                       max_images: int | None = None) -> dict:
    """Per-image per-category-word explanation statistics
    (analyze_{beta,mean}_of_category_generate_*, exaimin_word.py:371-460):
    for every predicted caption word in ``category_list``, record the
    sentinel beta, the mean projected LRP heatmap value and the mean
    projected attention. Returns {img_filename: {'predict_caption',
    'true_captions', 'beta': [(word, v)], 'lrp_mean': [...],
    'attention_mean': [...]}}."""
    cfg = explainer.captioner.cfg
    grid = int(round(float(np.sqrt(cfg.img_feature_length))))
    save: dict = {}
    gen = provider.test_set(include_datum=True)
    seen = set()
    n = 0
    for _ in range(provider.test_steps):
        (cap_in, imgs), y, data = next(gen)
        # gather the qualifying images of this provider batch, then explain
        # them in one length-sorted batched dispatch (analyze_many) instead
        # of two host<->device round trips per image
        pending = []
        for img, datum in zip(imgs, data):
            fname = datum.img_filename
            if fname in seen or fname not in id_to_prediction:
                continue
            seen.add(fname)
            predict_caption = id_to_prediction[fname]
            hits = [(c, word_index_in_caption(predict_caption, c))
                    for c in category_list if c in predict_caption.split()]
            hits = [(c, i) for c, i in hits if i is not None]
            if not hits:
                continue
            pending.append((img, fname, predict_caption, datum, hits))
        if not pending:
            continue
        if max_images:
            pending = pending[: max_images - n]
        explanations = explainer.analyze_many(
            np.stack([p[0] for p in pending]),
            batch_size=provider.batch_size)
        for (img, fname, predict_caption, datum, hits), explanation in zip(
                pending, explanations):
            entry = save.setdefault(fname, {
                "predict_caption": predict_caption,
                "true_captions": list(datum.all_captions_txt),
                "beta": [], "lrp_mean": [], "attention_mean": [],
            })
            W = len(explanation.words)
            for category, idx in hits:
                if idx >= W:
                    continue
                # hp processing of exaimin_word.py:79-104: channel-mean of the
                # BGR->RGB-recoded map, projected by absmax (no shift)
                hp = _project_pos_no_shift(explanation.relevance_maps[idx].mean(axis=-1))
                # upscale the attention to the RELEVANCE map's resolution
                # (224 at the reference protocol, 299 for inception, smaller
                # for test configs) so the two stats share one geometry
                upscale = explanation.relevance_maps[idx].shape[0] // grid
                atn = torch.as_tensor(np.asarray(explanation.attentions[idx], np.float32))
                atn = _project_pos_no_shift(pyramid_expand(
                    atn.reshape(grid, grid), upscale=upscale, sigma=20.0).numpy())
                entry["beta"].append((category, float(explanation.betas[idx])))
                entry["lrp_mean"].append((category, float(hp.mean())))
                entry["attention_mean"].append((category, float(atn.mean())))
            n += 1
            if max_images and n >= max_images:
                return save
    return save


def dump_word_stats(word_stats: dict, path: str) -> None:
    """Persist collected stats in the reference's pickle artifact layout:
    {img_filename: {'predict_caption': str, 'true_captions': [str],
    'beta': [(category, value)], ...}} — the ``save_dict`` pickles of
    analyze_*_of_category_generate_* (exaimin_word.py:413-414, 453-454,
    535-536, 576-577), so downstream reference analysis scripts
    (exaimin_word.py:623-746 load these with ``pickle.load``) can read them."""
    import os
    import pickle

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(word_stats, f)


def load_word_stats(path: str) -> dict:
    """Read a stats pickle written by :func:`dump_word_stats` (or by the
    reference's generate scripts — same layout)."""
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def _project_pos_no_shift(x: np.ndarray) -> np.ndarray:
    """x / max|x| without the negative shift (exaimin_word.py:80-89)."""
    absmax = np.max(np.abs(x))
    return np.zeros_like(x) if absmax == 0 else x / absmax


def pool_heatmap_to_grid(hp: np.ndarray, grid: int = 14, pooling: str = "max") -> np.ndarray:
    """Pool a (224,224) heatmap down to the attention grid, for comparing
    pixel relevance against attention cell-by-cell
    (_explain_single_word_pooling, exaimin_word.py:131-160)."""
    H = hp.shape[0]
    win = H // grid
    blocks = hp[: grid * win, : grid * win].reshape(grid, win, grid, win)
    if pooling == "max":
        return blocks.max(axis=(1, 3))
    if pooling == "avg":
        return blocks.mean(axis=(1, 3))
    raise ValueError(f"pooling {pooling!r} not in ('max', 'avg')")


def roc_curve(labels, scores):
    """(fpr, tpr, thresholds) of binary 0/1 ``labels`` against ``scores``, as
    ``sklearn.metrics.roc_curve`` gives them: one point per distinct score
    (tied scores share one threshold), the collinear points between corners
    dropped, and (0, 0) at threshold inf prepended. A rate whose class is
    absent is all NaN."""
    y = np.asarray(labels).ravel() == 1
    s = np.asarray(scores, dtype=np.float64).ravel()
    if y.shape != s.shape or not y.size:
        raise ValueError(f"labels {y.shape} and scores {s.shape} must be one non-empty length")
    if not np.isfinite(s).all():
        raise ValueError("scores must be finite")
    order = np.argsort(s, kind="stable")[::-1]
    s, y = s[order], y[order]
    # the last index of each run of equal scores, then the end of the curve
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = s[idx]
    if fps.shape[0] > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Area under the curve (x, y) by the trapezoid rule, x monotonic either
    way (``sklearn.metrics.auc``)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    if x.shape[0] < 2:
        raise ValueError(f"at least 2 points are needed to compute an area, got {x.shape}")
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing: {x}")
        direction = -1.0
    return float(direction * (dx * (y[1:] + y[:-1]) / 2.0).sum())


def _roc_auc(labels: list[int], scores: list[float]):
    fpr, tpr, _ = roc_curve(labels, scores)
    return fpr, tpr, auc(fpr, tpr)


def beta_roc_auc(word_stats: dict):
    """Does (1 - beta) predict whether the word is truly in the image?
    (analyze_category_beta_roc_auc, exaimin_word.py:623-651)."""
    labels, scores = [], []
    for entry in word_stats.values():
        refs = entry["true_captions"]
        for category, beta in entry["beta"]:
            in_ref = any(category in cap.split() for cap in refs)
            labels.append(1 if in_ref else 0)
            scores.append(1 - beta)
    return _roc_auc(labels, scores)


def mean_roc_auc(word_stats: dict, stat: str = "lrp_mean"):
    """ROC-AUC of mean-LRP / mean-attention scores
    (analyze_category_mean_roc_auc, exaimin_word.py:653-746)."""
    labels, scores = [], []
    for entry in word_stats.values():
        refs = entry["true_captions"]
        for category, v in entry[stat]:
            in_ref = any(category in cap.split() for cap in refs)
            labels.append(1 if in_ref else 0)
            scores.append(v)
    return _roc_auc(labels, scores)
