"""Shared set-up of the port's tests on the mini-Flickr30k fixture: both
packages' datasets, providers and captioners at a small size (32x32 images,
the block3_conv1 tap, E = H = 16, T = 6, as tests/test_torch_cli.py), with
one set of params from the JAX package's init carried across by
``params_from_jax``.

The decoder's params are scaled as tests/test_torch_cli.py scales them for
captions that vary, and the output bias favours the fixture's test-image
category words ("green", "dog", "yellow", "cat"): at seed 6 both test images
decode to "cat a green cat a green", which hits an annotated category of
each, so that the bbox and word statistics score real work.
"""

import jax
import numpy as np

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig
from lrp_imagecaptioning_tpu.data import datasets as jdatasets
from lrp_imagecaptioning_tpu.data.provider import DatasetProvider as JProvider
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig
from lrp_imagecaptioning_torch.data import datasets as tdatasets
from lrp_imagecaptioning_torch.data.provider import DatasetProvider as TProvider
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build
from lrp_imagecaptioning_torch.weights import params_from_jax

SMALL = dict(image_size=(32, 32), layer_name="block3_conv1", img_feature_length=64,
             img_feature_dim=256, embedding_dim=16, hidden_dim=16, sentence_length=6,
             words_min_occur=1, rare_words_handling="nothing", drop_rate=0.0, batch_size=4)
CATEGORY_WORDS = ("green", "dog", "yellow", "cat")


def jax_params(cap, vocabs, seed=6):
    """The JAX captioner's init, scaled and tilted to CATEGORY_WORDS, numpy leaves."""
    params = jax.tree.map(np.asarray, cap.init_params(jax.random.PRNGKey(seed)))
    d = params["decoder"]
    for name in ("image_features", "global_img_feature"):
        d[name]["kernel"] = d[name]["kernel"] * 0.01
    d["embedding"] = d["embedding"] * 10
    d["output"]["kernel"] = d["output"]["kernel"] * 10
    bias = np.random.default_rng(seed).normal(size=len(vocabs)).astype(np.float32) * 3
    for w in CATEGORY_WORDS:
        bias[vocabs.index(w)] += 2.0
    d["output"]["bias"] = bias
    return params


def build(root, model_type="adaptiveattention", seed=6):
    """{"jax": ..., "torch": ...}, each a dict of cfg, dataset, provider,
    captioner and params (the same values on both sides)."""
    out = {}
    for side, Config, ds_mod, Provider, build_cap in (
            ("jax", JConfig, jdatasets, JProvider, j_build),
            ("torch", TConfig, tdatasets, TProvider, t_build)):
        cfg = Config(dataset_root=root, **SMALL)
        dataset = ds_mod.Flickr30kDataset(cfg)
        provider = Provider(dataset, cfg)
        out[side] = dict(cfg=cfg, dataset=dataset, provider=provider,
                         cap=build_cap(model_type, cfg, provider.vocab_size))
    params = jax_params(out["jax"]["cap"], out["jax"]["provider"].vocabs, seed)
    out["jax"]["params"] = jax.tree.map(jax.numpy.asarray, params)
    out["torch"]["params"] = params_from_jax(params, "cpu")
    return out
