"""Explanation drivers: caption and explain images, render per-word heatmap
and attention grids.

The port of the JAX package's ``explain/drivers.py``: the reference's
``process_beam_search`` (models/explainers.py:191-256) and the ``Explainer``
wrapper of explain_image.py:27-150 with its ``explain_flickr30Kmodel`` /
``explain_COCOmodel`` entry points (explain_image.py:321-371), on
``explain.engine.Explainer``. The device work runs where ``device`` says
(default the card); the figures are drawn on the host with matplotlib,
imported inside ``render_explanation`` only.

Output layout as the reference's: ``<out>/<img_stem>/`` holds the resized
original, ``<stem><method>_hm.jpg`` (a word grid of seismic heatmaps) and
``<stem>attention.jpg`` (a word grid of attention blends).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.images import ImagePreprocessor, load_img_array
from ..utils.visualizations import heatmap, postprocess
from .cnn_gradient import pyramid_expand
from .engine import Explainer


def _word_grid(n: int):
    x = max(int(np.sqrt(n)), 1)
    y = int(np.ceil(n / x))
    return y, x


def _grid_side(cfg) -> int:
    return int(round(float(np.sqrt(cfg.img_feature_length))))


def render_explanation(explanation, raw_rgb_224: np.ndarray, save_folder: str,
                       img_filename: str, method: str = "lrp", grid: int = 14,
                       upscale: int = 16) -> list[str]:
    """Save the reference's two figure grids; returns the written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    os.makedirs(save_folder, exist_ok=True)
    stem = img_filename.split(".")[0]
    written = []

    img_original = Image.fromarray(np.uint8(raw_rgb_224.clip(0, 255)))
    orig_path = os.path.join(save_folder, img_filename)
    img_original.save(orig_path)
    written.append(orig_path)

    words = explanation.words
    y, x = _word_grid(max(len(words), 1))

    # grid 1: relevance heatmaps (seismic), channel-summed, BGR->RGB recoded
    _, axes = plt.subplots(y, x, sharex="col", sharey="row", figsize=(20, 20), squeeze=False)
    axes = axes.flatten()
    for i, word in enumerate(words):
        hp = postprocess(explanation.relevance_maps[i][None], "BGRtoRGB", False)
        axes[i].set_title(word, fontsize=18)
        axes[i].imshow(heatmap(hp)[0])
    for ax in axes:
        ax.set_axis_off()
    hm_path = os.path.join(save_folder, f"{stem}{method}_hm.jpg")
    plt.savefig(hm_path)
    plt.close()
    written.append(hm_path)

    # grid 2: attention blends (explainers.py:233-255)
    _, axes = plt.subplots(y, x, sharex="col", sharey="row", figsize=(20, 20), squeeze=False)
    axes = axes.flatten()
    for i, word in enumerate(words):
        atn = torch.as_tensor(np.asarray(explanation.attentions[i], np.float32))
        atn = pyramid_expand(atn.reshape(grid, grid), upscale=upscale, sigma=20.0).numpy()
        rng = atn.max() - atn.min()
        atn = (atn - atn.min()) / (rng if rng else 1.0) * 255
        overlay = np.zeros((*atn.shape, 3), np.uint8)
        overlay[:, :, 0] = atn.astype(np.uint8)
        overlay_img = Image.fromarray(overlay)
        if overlay_img.size != img_original.size:
            overlay_img = overlay_img.resize(img_original.size)
        blend = Image.blend(img_original, overlay_img, 0.7)
        axes[i].set_title(word, fontsize=18)
        axes[i].imshow(blend)
    for ax in axes:
        ax.set_axis_off()
    at_path = os.path.join(save_folder, f"{stem}attention.jpg")
    plt.savefig(at_path)
    plt.close()
    written.append(at_path)
    return written


def explain_image_file(captioner, params, caption_pp, img_path: str, out_dir: str,
                       method: str = "lrp", beam_size: int = 3, *, device="cuda"):
    """Explain one image file end to end and render its grids
    (explain_image.py:152-200, analyze_img)."""
    pp = ImagePreprocessor(encoder=captioner.cfg.img_encoder,
                           image_size=getattr(captioner.cfg, "image_size", None))
    size = pp._size
    raw = load_img_array(img_path, target_size=tuple(size))
    x = pp.preprocess_images([img_path])[0]
    explainer = Explainer(captioner, params, caption_pp, method=method, beam_size=beam_size,
                          device=device)
    explanation = explainer.analyze(x)
    img_filename = os.path.basename(img_path)
    save_folder = os.path.join(out_dir, img_filename.split(".")[0])
    g = _grid_side(captioner.cfg)
    render_explanation(explanation, raw, save_folder, img_filename, method=method,
                       grid=g, upscale=size[0] // g)
    return explanation


def process_beam_search(captioner, params, provider, out_dir: str, method: str = "lrp",
                        beam_size: int = 3, num_images: int = 1, *, device="cuda"):
    """Reference process_beam_search: explain the first test images and write
    their figure grids (explainers.py:191-256)."""
    gen = provider.test_set(include_datum=True)
    done = 0
    results = []
    explainer = Explainer(captioner, params, provider.caption_preprocessor,
                          method=method, beam_size=beam_size, device=device)
    g = _grid_side(captioner.cfg)
    while done < num_images:
        (cap_in, imgs), y, data = next(gen)
        for img_arr, datum in zip(imgs, data):
            if done >= num_images:
                break
            explanation = explainer.analyze(img_arr)
            img_filename = os.path.basename(datum.img_path)
            save_folder = os.path.join(out_dir, img_filename.split(".")[0])
            raw = load_img_array(datum.img_path)
            render_explanation(explanation, raw, save_folder, img_filename,
                               method=method, grid=g, upscale=224 // g)
            results.append(explanation)
            done += 1
    return results


def explain_flickr30k_model(config, dataset, weights_path: str, model_type: str,
                            method: str = "lrp", out_dir: str | None = None, num_images: int = 1,
                            *, device="cuda"):
    """explain_flickr30Kmodel equivalent (explain_image.py:321-345)."""
    return _explain_dataset_model(config, dataset, weights_path, model_type, method, out_dir,
                                  num_images, device)


def explain_coco_model(config, dataset, weights_path: str, model_type: str,
                       method: str = "lrp", out_dir: str | None = None, num_images: int = 1,
                       *, device="cuda"):
    """explain_COCOmodel equivalent (explain_image.py:348-371)."""
    return _explain_dataset_model(config, dataset, weights_path, model_type, method, out_dir,
                                  num_images, device)


def _explain_dataset_model(config, dataset, weights_path, model_type, method, out_dir,
                           num_images, device):
    """Weights from an npz (the port's checkpoint or the JAX package's flat
    params); an orbax directory raises (``train/trainer.py::load_weights_file``)."""
    from ..data.provider import DatasetProvider
    from ..models.captioner import build_captioner
    from ..train.trainer import load_weights_file

    provider = DatasetProvider(dataset, config)
    captioner = build_captioner(model_type, config, provider.vocab_size)
    params = load_weights_file(weights_path, captioner, device)[0]
    out = out_dir or (weights_path + ".explanation")
    return process_beam_search(captioner, params, provider, out, method=method,
                               num_images=num_images, device=device)
