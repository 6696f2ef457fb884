"""PyTorch port: decoder LRP, CNN LRP and the whole caption + explain slice
against the JAX package.

LRP maps are compared relative to each map's scale (max |ref|): the
divides by stab(z) at eps = 1e-7 amplify last-ulp differences of the
forward sums, so an absolute tolerance would be meaningless. Bound: 1e-4 of
the scale (the measured gap is ~1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.explain.cnn_lrp import (  # noqa: E402
    vgg_lrp_preset_a_wordbatched as j_cnn_lrp,
)
from lrp_imagecaptioning_tpu.explain.decoder_lrp import explain_word_adaptive as j_explain  # noqa: E402
from lrp_imagecaptioning_tpu.models import adaptive as jad  # noqa: E402
from lrp_imagecaptioning_tpu.models import vgg as jvgg  # noqa: E402
from lrp_imagecaptioning_torch import pipeline  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.cnn_lrp import (  # noqa: E402
    vgg_lrp_preset_a_wordbatched as t_cnn_lrp,
)
from lrp_imagecaptioning_torch.explain.decoder_lrp import explain_word_adaptive as t_explain  # noqa: E402
from lrp_imagecaptioning_torch.models import adaptive as tad  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

MAP_RTOL = 1e-4


def _assert_map_close(got, ref, rtol=MAP_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= rtol * scale, np.abs(got - ref).max() / scale


def test_explain_word_adaptive_matches_jax_every_t():
    E, H, D, L, V, T, B = 8, 12, 16, 9, 20, 5, 2
    cfg = JConfig(embedding_dim=E, hidden_dim=H, img_feature_dim=D, img_feature_length=L)
    pj = jad.init_params(jax.random.PRNGKey(4), V, cfg)
    pt = params_from_jax(pj, "cpu")
    rng = np.random.default_rng(40)
    feat = rng.normal(size=(B, L, D)).astype(np.float32)
    inputs = rng.integers(0, V, size=(B, T))
    words = rng.integers(0, V, size=(B, T))

    cj = jad.prepare_consts(pj, jnp.asarray(feat))
    kj = jad.forward_cached_from_inputs(pj, cj, jnp.asarray(inputs), H)
    ct = tad.prepare_consts(pt, torch.from_numpy(feat))
    kt = tad.forward_cached_from_inputs(pt, ct, torch.from_numpy(inputs), H)
    r_feat, r_words, att = t_explain(pt, ct, kt, torch.from_numpy(words))
    assert r_feat.shape == (B, T, L, D) and r_words.shape == (B, T, T) and att.shape == (B, T, L)

    explain = jax.jit(j_explain, static_argnums=(5,))
    for b in range(B):
        cb = jax.tree.map(lambda x: x[b], cj)
        kb = jax.tree.map(lambda x: x[:, b], kj)
        for t in range(T):
            rf, rw, a = explain(pj, cb, kb, jnp.int32(t), jnp.int32(words[b, t]), T)
            _assert_map_close(r_feat[b, t], rf)
            _assert_map_close(r_words[b, t], rw)
            np.testing.assert_allclose(att[b, t].numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("lane_pack", [False, True])
def test_vgg_lrp_preset_a_wordbatched_matches_jax(lane_pack):
    until = "block2_conv2"   # reaches past the lane-packed C<=64 tail
    pj = jvgg.init_vgg_params(jax.random.PRNGKey(2), "vgg16", until)
    pt = params_from_jax(pj, "cpu")
    rng = np.random.default_rng(41)
    image = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    seeds = rng.normal(size=(3, 8, 8, 128)).astype(np.float32)
    ref = j_cnn_lrp(pj, jnp.asarray(image), jnp.asarray(seeds), "vgg16", until, lane_pack=lane_pack)
    got = t_cnn_lrp(pt, torch.from_numpy(image), torch.from_numpy(seeds), until=until)
    assert got.shape == (3, 16, 16, 3)
    for w in range(3):
        _assert_map_close(got[w], ref[w])


OVERRIDES = dict(embedding_dim=16, hidden_dim=16, layer_name="block3_conv1", img_feature_length=64,
                 img_feature_dim=256, sentence_length=4, drop_rate=0.0, image_size=(32, 32))


def test_caption_and_explain_matches_bench(monkeypatch):
    """The whole slice: the port's pipeline against bench.build (f32)."""
    B, V, T, K = 2, 32, 4, 3
    monkeypatch.setenv("LRPIC_BENCH_F32", "1")
    monkeypatch.setattr(bench, "BATCH", B)
    monkeypatch.setattr(bench, "VOCAB", V)
    monkeypatch.setattr(bench, "T", T)
    monkeypatch.setattr(bench, "BEAM", K)
    monkeypatch.setattr(bench, "CFG_OVERRIDES", OVERRIDES)
    fn_j, params_j = bench.build()
    images = np.random.default_rng(42).normal(size=(B, 32, 32, 3)).astype(np.float32)
    tok_j, maps_j = fn_j(params_j, jnp.asarray(images))
    tok_j, maps_j = np.asarray(tok_j), np.asarray(maps_j)

    port_cfg = TConfig(**{k: v for k, v in OVERRIDES.items() if k not in ("drop_rate", "image_size", "sentence_length")})
    fn_t, _ = pipeline.build(port_cfg, V, device="cpu", beam=K, T=T)
    params_t = params_from_jax(params_j, "cpu")
    tok_t, maps_t = fn_t(params_t, images)
    np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    assert maps_t.shape == (B, T, 32, 32, 3)

    # the LRP stages on JAX's own tokens, so the maps are compared on the same words
    st = fn_t.stages
    img_t = torch.from_numpy(images)
    feat, _ = st["caption"](params_t, img_t)
    r_feat = st["decoder_lrp"](params_t, feat, torch.tensor(tok_j, dtype=torch.long))
    maps_on_j = st["cnn_lrp"](params_t, img_t, r_feat)
    for b in range(B):
        for t in range(T):
            _assert_map_close(maps_on_j[b, t], maps_j[b, t])
            _assert_map_close(maps_t[b, t], maps_j[b, t])
