"""PyTorch port: the VGG19 encoder (models/vgg.py ``arch='vgg19'``) through
the CNN LRP, DeepTaylor, DeepLIFT and the gradient methods, against the JAX
package on the CPU.

Size: VGG19 at 32x32 with full channel widths, tapped at block3_conv4 (a
VGG19-only layer; 8x8x256) for the Explainer and at block5_conv4 (2x2x512)
for the forward and the LRP walk; adaptive attention at E = H = 32, vocab
50, T = 5; the JAX init's params on both sides.

Tolerances, each with its reason: the forward 1e-5 of scale (f32 sums in
another order); the LRP walk 1e-4 (the divides by z amplify last ulps); the
Explainer as tests/test_torch_resnet.py (DeepLIFT's CNN side in f64 at
1e-9); bf16 storage as tests/test_torch_bf16.py: within 2x the JAX bf16 run's
distance from the JAX f32 maps and within 3e-2 of their scale.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_encoders as te  # noqa: E402
from lrp_imagecaptioning_tpu.explain import cnn_lrp as jlrp  # noqa: E402
from lrp_imagecaptioning_tpu.explain.engine import Explainer as JExplainer  # noqa: E402
from lrp_imagecaptioning_tpu.models import vgg as jvgg  # noqa: E402
from lrp_imagecaptioning_torch.explain import cnn_lrp as tlrp  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.models import vgg as tvgg  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

TAP = dict(layer_name="block3_conv4", img_feature_length=64, img_feature_dim=256)
METHODS = ("lrp", "deep_taylor", "deep_lift", *te.GRADIENT_METHODS)


@pytest.fixture(scope="module")
def pair():
    return te.build_pair("adaptiveattention", "vgg19", **TAP)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("until", ["block5_conv4", "block3_conv4"])
def test_layers_and_forward_match_jax(until):
    assert tvgg.vgg_layers("vgg19", until) == jvgg.vgg_layers("vgg19", until)
    enc = te.encoder_params("vgg19", layer_name=until)
    x = te.images("vgg19")
    ref, ref_in = jvgg.vgg_apply_with_acts(jax.tree.map(jnp.asarray, enc), jnp.asarray(x),
                                           "vgg19", until)
    got, got_in = tvgg.vgg_apply_with_acts(params_from_jax(enc, "cpu"), _t(x), "vgg19", until)
    assert len(got_in) == len(ref_in)
    assert te.rel(got.numpy(), ref) <= 1e-5
    assert te.rel(tvgg.vgg_apply(params_from_jax(enc, "cpu"), _t(x), "vgg19", until).numpy(),
                  ref) <= 1e-5


def test_lrp_walk_matches_jax():
    """The word-batched PresetA walk through all 16 convs (15 on K3's plain
    version), two seeds against one image."""
    enc = te.encoder_params("vgg19")
    x = te.images("vgg19", n=1)
    seeds = np.random.default_rng(3).normal(size=(2, 2, 2, 512)).astype(np.float32)
    ref = np.asarray(jlrp.vgg_lrp_preset_a_wordbatched(
        jax.tree.map(jnp.asarray, enc), jnp.asarray(x), jnp.asarray(seeds), "vgg19",
        "block5_conv4"))
    got = tlrp.vgg_lrp_preset_a_wordbatched(params_from_jax(enc, "cpu"), _t(x), _t(seeds), "vgg19",
                                            "block5_conv4").numpy()
    assert got.shape == (2, 32, 32, 3) and te.rel(got, ref) <= 1e-4


@pytest.mark.parametrize("method", METHODS)
def test_explainer_matches_jax(pair, method):
    te.check_explainer(*pair, method, "vgg19")


def test_lrp_bf16_storage_matches_jax(pair):
    jcap, pj, tcap, pt = pair
    img = te.images("vgg19", n=1)
    toks = te.TOKENS[:1]
    anchor = JExplainer(jcap, pj, te.FakePP(), beam_size=2).analyze_batch(img, tokens_1based=toks)
    ref = JExplainer(jcap, pj, te.FakePP(), beam_size=2, storage_dtype=jnp.bfloat16
                     ).analyze_batch(img, tokens_1based=toks)
    got = Explainer(tcap, pt, te.FakePP(), beam_size=2, device="cpu",
                    storage_dtype=torch.bfloat16).analyze_batch(img, tokens_1based=toks)
    for g, r, a in zip(got, ref, anchor):
        assert g.relevance_maps.dtype == np.float32
        for w in range(len(g.words)):
            d_port = te.rel(g.relevance_maps[w], a.relevance_maps[w])
            d_jax = te.rel(r.relevance_maps[w], a.relevance_maps[w])
            assert d_port <= 3e-2 and d_port <= 2.0 * d_jax, (d_port, d_jax)


def test_h5_round_trip_from_the_jax_writer(pair, tmp_path):
    from lrp_imagecaptioning_tpu.models.weights_io import save_reference_checkpoint_h5
    from lrp_imagecaptioning_torch.models.weights_io import load_reference_checkpoint_h5

    _, pj, _, _ = pair
    path = os.path.join(tmp_path, "vgg19.h5")
    save_reference_checkpoint_h5(path, pj, "adaptiveattention", "vgg19", TAP["layer_name"])
    got = load_reference_checkpoint_h5(path, "adaptiveattention", "vgg19", TAP["layer_name"],
                                       device="cpu")
    leaves = te.tree_pairs(params_from_jax(pj, "cpu"), got)
    assert len(leaves) == len(jax.tree.leaves(pj))
    assert "block3_conv4" in got["vgg"]
    for path_, a, b in leaves:
        assert torch.equal(a, b), path_
