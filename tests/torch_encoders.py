"""Shared pieces of the port's encoder and AOA tests (tests/test_torch_resnet.py,
test_torch_inception.py, test_torch_aoa.py, test_torch_vgg19.py).

Both packages get one params tree: the encoder's from the port's own init
(the JAX init of ResNet and Inception takes 10-25 s of eager random ops on
a CPU), with BatchNorm's gamma, beta and moving statistics drawn from a
numpy seed (under the init's 1/0/0/1 the BN rule gives back its input
whatever its code), handed to the JAX captioner's ``init_params(
encoder_params=)`` for the decoder, then through ``params_from_jax``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig
from lrp_imagecaptioning_tpu.explain.engine import Explainer as JExplainer
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig
from lrp_imagecaptioning_torch.explain.engine import Explainer
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_map, tree_to

VOCAB = 50
E = H = 32
# each encoder at a small input, full channel widths
ENCODERS = {
    "resnet50": dict(layer_name="activation_49", img_feature_length=4, img_feature_dim=2048,
                     image_size=(64, 64)),
    "resnet101": dict(layer_name="activation_49", img_feature_length=1, img_feature_dim=2048,
                      image_size=(32, 32)),
    "inception_v3": dict(layer_name="mixed10", img_feature_length=1, img_feature_dim=2048,
                         image_size=(75, 75)),
    "vgg19": dict(layer_name="block5_conv4", img_feature_length=4, img_feature_dim=512,
                  image_size=(32, 32)),
    "vgg16": dict(layer_name="block5_conv3", img_feature_length=4, img_feature_dim=512,
                  image_size=(32, 32)),
}
FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances", "betas")
GRADIENT_METHODS = ("gradient", "input_times_gradient", "guided_backprop", "guided_gradcam",
                    "deconvnet", "integrated_gradients", "smoothgrad")
# 3 and 2 real words, then EOS
TOKENS = np.array([[5, 7, 6, 2, 0], [8, 9, 2, 0, 0]], np.int32)


class FakePP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}
    word_of[1], word_of[2] = "szeros", "zeros"


def config_kw(encoder, **over):
    """The test config of ``encoder``; ``over`` replaces any of its fields."""
    return dict(dict(img_encoder=encoder, embedding_dim=E, hidden_dim=H, sentence_length=5,
                     **ENCODERS[encoder]), **over)


def random_bn(tree, seed):
    """Every BatchNorm leaf of an encoder tree (numpy) drawn from ``seed``:
    gamma and the variance in [0.5, 1.5], beta and the mean N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    draws = {"gamma": lambda s: rng.uniform(0.5, 1.5, s), "bn_gamma": lambda s: rng.uniform(0.5, 1.5, s),
             "moving_var": lambda s: rng.uniform(0.5, 1.5, s), "bn_var": lambda s: rng.uniform(0.5, 1.5, s),
             "beta": lambda s: rng.normal(0, 0.1, s), "bn_beta": lambda s: rng.normal(0, 0.1, s),
             "moving_mean": lambda s: rng.normal(0, 0.1, s), "bn_mean": lambda s: rng.normal(0, 0.1, s)}
    for name in sorted(tree):
        node = tree[name]
        for k in sorted(node):
            if k in draws:
                node[k] = draws[k](node[k].shape).astype(np.float32)
    return tree


def encoder_params(encoder, seed=0, **over):
    """The encoder's params (numpy) from the port's init, BN drawn."""
    tcap = t_build("adaptiveattention", TConfig(**config_kw(encoder, **over)), VOCAB)
    enc = tree_map(lambda t: t.numpy(), tcap.init_encoder_params(torch.Generator().manual_seed(seed)))
    return random_bn(enc, seed + 100) if not encoder.startswith("vgg") else enc


def build_pair(model_type, encoder, enc_np=None, key=3, **over):
    """(JAX captioner, JAX params, port captioner, port params) over one tree."""
    drop = over.pop("drop_rate", 0.0)
    enc_np = encoder_params(encoder, **over) if enc_np is None else enc_np
    kw = config_kw(encoder, **over)
    jcap = j_build(model_type, JConfig(drop_rate=drop, **kw), VOCAB)
    pj = jcap.init_params(jax.random.PRNGKey(key),
                          encoder_params=jax.tree.map(jnp.asarray, enc_np))
    tcap = t_build(model_type, TConfig(drop_rate=drop, **kw), VOCAB)
    return jcap, pj, tcap, params_from_jax(pj, "cpu")


def images(encoder, n=2, seed=1, size=None):
    """Numpy-seeded images at the encoder's size (or ``size``): caffe-range
    for VGG and ResNet, [-1, 1]-range for Inception."""
    size = size or ENCODERS[encoder]["image_size"]
    scale = 0.5 if encoder == "inception_v3" else 40.0
    return (np.random.default_rng(seed).normal(size=(n, *size, 3)) * scale).astype(np.float32)


def rel(got, ref):
    """max |got - ref| over max |ref| (0 for an empty or all-zero ref)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / scale) if scale else float(np.abs(got).max())


def explanation_dists(got, ref, fields=FIELDS):
    """Per field, the largest ``rel`` over the images; the words must match."""
    out = dict.fromkeys(fields, 0.0)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.words == r.words and g.caption == r.caption
        np.testing.assert_array_equal(g.tokens_1based, r.tokens_1based)
        for name in fields:
            a, b = getattr(g, name), np.asarray(getattr(r, name))
            assert a.shape == b.shape, name
            assert np.isfinite(a).all(), name
            out[name] = max(out[name], rel(a, b))
    return out


def jax_generic_smoothgrad_noise(image_shape, samples, seed=0):
    """The JAX Explainer's non-VGG SmoothGrad draws: one set per image,
    ``split(PRNGKey(seed), samples)``, one normal of the image's shape each
    (engine.py:337-341)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), samples)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, image_shape, jnp.float32))
                                      for k in keys]))


def jax_smoothgrad_noise(n_words, image_shape, samples, seed=0):
    """The JAX Explainer's VGG SmoothGrad draws, keyed per word position
    (engine.py:412-416)."""
    out = []
    for p in range(n_words):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), p), samples)
        out.append(np.stack([np.asarray(jax.random.normal(k, (1, *image_shape), jnp.float32))[0]
                             for k in keys]))
    return torch.from_numpy(np.stack(out))


NOISY_METHODS = ("integrated_gradients", "smoothgrad")


def deeplift_cnn_f64(pj, tex64, image, seeds, encoder):
    """DeepLIFT's CNN side in f64, the port's (``Explainer._cnn``) and the JAX
    package's word-batched function -> (port, JAX). Its rescale rule divides
    by Δy, which cancels in f32 (tests/test_torch_deep_methods.py)."""
    from lrp_imagecaptioning_tpu.explain import cnn_deeplift, inception_lrp, resnet_lrp

    cfg = tex64.captioner.cfg
    with jax.enable_x64(True):
        enc64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), pj["vgg"])
        x, s = jnp.asarray(image[None], jnp.float64), jnp.asarray(seeds, jnp.float64)
        if encoder.startswith("vgg"):
            ref = jax.vmap(lambda w: cnn_deeplift.vgg_deeplift(
                enc64, x, w[None], encoder, cfg.layer_name)[0])(s)
        elif encoder.startswith("resnet"):
            ref = resnet_lrp.resnet_deeplift_wordbatched(enc64, x, s, encoder)
        else:
            ref = inception_lrp.inception_deeplift_wordbatched(enc64, x, s, cfg.layer_name)
        ref = np.asarray(ref)
    L, D = seeds.shape[1] * seeds.shape[2], seeds.shape[3]
    xt = torch.from_numpy(np.asarray(image, np.float64))[None]
    with torch.no_grad():
        got = tex64._cnn(xt, tex64._encode(xt), torch.from_numpy(np.asarray(seeds, np.float64))
                         .reshape(1, len(seeds), L, D))[0]
    return got.numpy(), ref


def generic_cnn_f64(jcap, pj, tex64, image, seeds, method, steps=2, samples=2):
    """The CNN side of IG or SmoothGrad through ResNet or Inception in f64,
    the port's (``Explainer._cnn`` on given seeds) and the JAX engine's
    recipe (engine.py:310-367: one ``jax.vjp`` of its ``encode`` per alpha or
    noise key and seed) -> (port, JAX). In f32 a ReLU that the noisy or
    scaled forwards near-tie can flip in either package, moving a map by
    ~1e-3 of its scale, so these two are held in f64."""
    L, D = seeds.shape[1] * seeds.shape[2], seeds.shape[3]
    noise = jax_generic_smoothgrad_noise(image.shape, samples).double().numpy()
    with jax.enable_x64(True):
        pj64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), pj)
        img = jnp.asarray(image, jnp.float64)

        @jax.jit
        def vjp_at(x, s):
            _, vjp = jax.vjp(lambda im: jcap.encode(pj64, im[None])[0], x)
            return vjp(s)[0]

        def grad_at(x, s):
            return np.asarray(vjp_at(x, jnp.asarray(s.reshape(L, D), jnp.float32)))

        if method == "integrated_gradients":
            ref = [np.asarray(img) * np.mean([grad_at((k + 0.5) / steps * img, s)
                                              for k in range(steps)], axis=0) for s in seeds]
        else:
            ref = [np.mean([grad_at(img + tex64._sg_noise * noise[k], s)
                            for k in range(samples)], axis=0) for s in seeds]
    tex64._ig_steps, tex64._sg_samples = steps, samples
    tex64.generic_smoothgrad_noise = lambda shape: torch.from_numpy(noise)
    x = torch.from_numpy(np.asarray(image, np.float64))[None]
    with torch.no_grad():
        feat = tex64._encode(x)
        got = tex64._cnn(x, feat, torch.from_numpy(np.asarray(seeds, np.float64))
                         .reshape(1, len(seeds), L, D))[0]
    return got.numpy(), np.stack(ref)


def explainer_pair(jcap, pj, tcap, pt, method, encoder):
    """(port Explainer, its f64 twin, JAX Explainer), IG at 2 steps and
    SmoothGrad at 2 samples, the port fed JAX's noise. The twin runs the
    CNN sides held in f64 (``deeplift_cnn_f64``, ``generic_cnn_f64``)."""
    exs = []
    for params in (pt, tree_to(pt, dtype=torch.float64)):
        ex = Explainer(tcap, params, FakePP(), method=method, beam_size=2, device="cpu")
        ex._ig_steps, ex._sg_samples = 2, 2
        dt = params["decoder"]["embedding"].dtype
        ex.smoothgrad_noise = lambda n, s, dt=dt: jax_smoothgrad_noise(n, s, 2).to(dt)
        ex.generic_smoothgrad_noise = lambda s, dt=dt: jax_generic_smoothgrad_noise(s, 2).to(dt)
        exs.append(ex)
    jex = JExplainer(jcap, pj, FakePP(), method=method, beam_size=2)
    jex._ig_steps, jex._sg_samples = 2, 2
    return (*exs, jex)


def check_explainer(jcap, pj, tcap, pt, method, encoder, n_images=1, **over):
    """The port's Explainer against JAX's on ``n_images`` images with given
    captions: every field within 1e-4 of scale. For DeepLIFT, and IG and
    SmoothGrad on ResNet / Inception, the f32 maps are only held finite and
    the CNN side is held in f64 instead (``deeplift_cnn_f64``,
    ``generic_cnn_f64``)."""
    tex, t64, jex = explainer_pair(jcap, pj, tcap, pt, method, encoder)
    img = images(encoder, n=n_images, size=over.get("image_size"))
    toks = TOKENS[:n_images]
    got = tex.analyze_batch(img, tokens_1based=toks)
    ref = jex.analyze_batch(img, tokens_1based=toks)
    noisy = method in NOISY_METHODS and not encoder.startswith("vgg")
    f64_cnn = noisy or method == "deep_lift"
    fields = tuple(f for f in FIELDS if not (f64_cnn and f == "relevance_maps"))
    dists = explanation_dists(got, ref, fields)
    assert max(dists.values()) <= 1e-4, dists
    assert all(np.isfinite(e.relevance_maps).all() for e in got)
    if f64_cnn:
        seeds = got[0].feat_relevance[:1].reshape(-1, *_grid(tcap.cfg))
        if method == "deep_lift":
            port, jax_ref = deeplift_cnn_f64(pj, t64, img[0], seeds, encoder)
        else:
            port, jax_ref = generic_cnn_f64(jcap, pj, t64, img[0], seeds, method)
        assert np.abs(port).max() > 0 and rel(port, jax_ref) <= 1e-9
    else:
        assert sum(float(np.abs(e.relevance_maps).sum()) for e in got) > 0
    return got


def _grid(cfg):
    g = int(round(cfg.img_feature_length ** 0.5))
    return g, g, cfg.img_feature_dim


def tree_pairs(a, b, path=""):
    """[(path, leaf of a, leaf of b)] of two trees of the same structure."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        return [p for k in sorted(a) for p in tree_pairs(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in tree_pairs(x, y, f"{path}/{i}")]
    return [(path, a, b)]
