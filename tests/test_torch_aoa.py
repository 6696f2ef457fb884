"""PyTorch port: the AOA decoder (models/aoa.py, explain/aoa_backward.py) and
its training and fine-tuning against the JAX package on the CPU.

Size: E = H = 32 with 8 heads (d_k 4), vocab 50, T = 5, over VGG16 at 8x8
tapped at block2_conv1 (4x4x128); the JAX init's params on both sides
(``params_from_jax``), inputs made with numpy.

Tolerances, each with its reason:
* consts, logits and the losses: 1e-5 of the scale and rel 1e-6 (f32 sums
  in another order);
* the decoder LRP and gradient: 1e-4 of each output's scale (the divides by
  stab(z) amplify last-ulp differences);
* gradients of the loss: 1e-4 of each leaf's max |g|, but the key
  projection's bias, whose gradient is 0 in exact arithmetic (softmax is
  shift-invariant): under 1e-6 of the largest leaf's on both sides; a train
  or fine-tune step's update where |g| > 1e-3 max |g|, 1e-4 of its scale
  (Adam's first step is lr sign(g));
* the Explainer: as tests/test_torch_resnet.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_encoders as te  # noqa: E402
from lrp_imagecaptioning_tpu.explain import aoa_backward as jab  # noqa: E402
from lrp_imagecaptioning_tpu.infer.beam import beam_search as j_beam  # noqa: E402
from lrp_imagecaptioning_tpu.infer.greedy import greedy_decode as j_greedy  # noqa: E402
from lrp_imagecaptioning_tpu.models import aoa as jaoa  # noqa: E402
from lrp_imagecaptioning_tpu.models import cells as jcells  # noqa: E402
from lrp_imagecaptioning_tpu.train import lrp_finetune as jft  # noqa: E402
from lrp_imagecaptioning_tpu.train import optimizer as jopt  # noqa: E402
from lrp_imagecaptioning_tpu.train.step import make_train_step as j_make_train_step  # noqa: E402
from lrp_imagecaptioning_torch.explain import aoa_backward as tab  # noqa: E402
from lrp_imagecaptioning_torch.infer.beam import beam_search as t_beam  # noqa: E402
from lrp_imagecaptioning_torch.infer.greedy import greedy_decode as t_greedy  # noqa: E402
from lrp_imagecaptioning_torch.models import aoa as taoa  # noqa: E402
from lrp_imagecaptioning_torch.train import lrp_finetune as tft  # noqa: E402
from lrp_imagecaptioning_torch.train import optimizer as topt  # noqa: E402
from lrp_imagecaptioning_torch.train import step as tstep  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

ENC = "vgg16"
B, T = 3, 6
STOP = np.zeros(te.VOCAB + 1, bool)
STOP[[5, 9]] = True


SMALL = dict(layer_name="block2_conv1", img_feature_length=16, img_feature_dim=128,
             image_size=(8, 8))


@pytest.fixture(scope="module")
def pair():
    """VGG16 to block2_conv1 at 8x8, dropout 0.5 (where a forward is given a
    generator or masks)."""
    return te.build_pair("aoa", ENC, drop_rate=0.5, **SMALL)


def _t(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if not t.is_floating_point() else t


def _feat(seed, batch=B):
    return np.random.default_rng(seed).normal(size=(batch, 16, 128)).astype(np.float32)


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = (rng.normal(size=(B, 8, 8, 3)) * 40).astype(np.float32)
    caps = rng.integers(0, te.VOCAB, size=(B, T)).astype(np.int32)
    y = np.eye(te.VOCAB, dtype=np.float32)[rng.integers(0, te.VOCAB, size=(B, T))]
    y[0, -2:] = 0                      # padding rows
    return images, caps, y


def _close(got, ref, tol):
    assert te.rel(got, ref) <= tol, te.rel(got, ref)


@pytest.mark.parametrize("refine", [0, 1])
def test_consts_and_cached_forward_match_jax(pair, refine):
    """prepare_consts (layer norm, image_features, ``refine`` self-attention
    blocks, K/V) and the cached forward's every field."""
    jcap = pair[0]
    pj = jaoa.init_params(jax.random.PRNGKey(7), te.VOCAB, jcap.cfg, encoder_refine_num=refine)
    pt = params_from_jax(pj, "cpu")
    feat = _feat(1)
    cj = jaoa.prepare_consts(pj, jnp.asarray(feat))
    ct = taoa.prepare_consts(pt, _t(feat))
    for name in taoa.AOAConsts._fields:
        _close(getattr(ct, name).numpy(), getattr(cj, name), 1e-5)
    toks = np.random.default_rng(2).integers(0, te.VOCAB, size=(B, T)).astype(np.int32)
    kj = jaoa.forward_cached_from_inputs(pj, cj, jnp.asarray(toks), te.H)
    kt = taoa.forward_cached_from_inputs(pt, ct, _t(toks), te.H)
    for name in taoa.AOAStepCache._fields:
        got, ref = getattr(kt, name).numpy(), np.asarray(getattr(kj, name))
        assert got.shape == ref.shape, name
        _close(got, ref, 1e-5)


@pytest.mark.parametrize("search", ["beam", "greedy"])
def test_decode_matches_jax(pair, search):
    jcap, pj, tcap, pt = pair
    feat = _feat(3) * 3
    if search == "beam":
        tj, sj = j_beam(jcap, pj, jnp.asarray(feat), 1, 2, 3, 5)
        tt, st = t_beam(tcap, pt, _t(feat), 1, 2, 3, 5)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)
    else:
        tj = j_greedy(jcap, pj, jnp.asarray(feat), 1, 2, 5)
        tt = t_greedy(tcap, pt, _t(feat), 1, 2, 5)
        tj, tt = (x[0] if isinstance(x, tuple) else x for x in (tj, tt))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def _caches(pj, pt, seed):
    feat = _feat(seed)
    toks = np.random.default_rng(seed + 1).integers(0, te.VOCAB, size=(B, T)).astype(np.int32)
    cj = jaoa.prepare_consts(pj["decoder"], jnp.asarray(feat))
    kj = jaoa.forward_cached_from_inputs(pj["decoder"], cj, jnp.asarray(toks), te.H)
    ct = taoa.prepare_consts(pt["decoder"], _t(feat))
    kt = taoa.forward_cached_from_inputs(pt["decoder"], ct, _t(toks), te.H)
    words = np.random.default_rng(seed + 2).integers(0, te.VOCAB, size=(B, T)).astype(np.int32)
    return cj, kj, ct, kt, words


@pytest.mark.parametrize("backward", ["explain_word_aoa", "grad_word_aoa"])
def test_decoder_backward_matches_jax(pair, backward):
    """Every (image, step) row at once against the JAX function vmapped over
    the steps of each image; then chosen positions gather the same rows."""
    _, pj, _, pt = pair
    cj, kj, ct, kt, words = _caches(pj, pt, 4)
    jfn, tfn = getattr(jab, backward), getattr(tab, backward)
    got = tfn(pt["decoder"], ct, kt, _t(words))
    for b in range(B):
        consts = jax.tree.map(lambda x: x[b], cj)
        caches = jax.tree.map(lambda x: x[:, b], kj)
        ref = jax.vmap(lambda t, w: jfn(pj["decoder"], consts, caches, t, w, T))(
            jnp.arange(T), jnp.asarray(words[b]))
        for g, r in zip(got, ref):
            _close(g[b].numpy(), r, 1e-4)
    pos = np.array([[0, 3], [5, 1], [2, 2]])
    part = tfn(pt["decoder"], ct, kt, _t(np.take_along_axis(words, pos, 1)), _t(pos))
    for g, p in zip(part, got):
        _close(g.numpy(), np.take_along_axis(p.numpy(), pos.reshape(B, 2, *[1] * (p.dim() - 2)),
                                             1), 1e-6)


@pytest.mark.parametrize("method", ("lrp", "deep_taylor", "deep_lift", *te.GRADIENT_METHODS))
def test_explainer_matches_jax(pair, method):
    """All 10 methods through Explainer.analyze_batch on two images; AOA's
    betas are zeros (it has no sentinel)."""
    got = te.check_explainer(*pair, method, ENC, n_images=2, **SMALL)
    assert all(not e.betas.any() for e in got)


def _jax_masks(rng_key, pj, rate, batch):
    """The masks of the JAX AOA forward_train at this key, drawn as it draws
    them (models/aoa.py:189-205)."""
    ks = jax.random.split(rng_key, 4)
    keep = 1.0 - rate
    H, V = pj["decoder"]["output"]["kernel"].shape
    E = pj["decoder"]["embedding"].shape[-1]

    def bern(k, shape):
        return _t(np.asarray(jax.random.bernoulli(k, keep, shape), np.float32) / keep)

    lstm = jcells.lstm_dropout_masks(ks[3], E + H, te.H, rate, batch=batch)
    return taoa.AOADropoutMasks(v_feat=bern(ks[0], (batch, 16, H)), out=bern(ks[1], (batch, H)),
                                logit=bern(ks[2], (batch, V)),
                                lstm=tuple(_t(np.asarray(m)) for m in lstm))


@pytest.mark.parametrize("dropout", ["none", "jax_masks"])
def test_forward_train_matches_jax(pair, dropout):
    jcap, pj, tcap, pt = pair
    images, caps, _ = _batch(5)
    key = jax.random.PRNGKey(5) if dropout == "jax_masks" else None
    ref = np.asarray(jcap.forward_train(pj, jnp.asarray(images), jnp.asarray(caps), key))
    masks = _jax_masks(key, pj, 0.5, B) if key is not None else None
    got = tcap.forward_train(pt, _t(images), _t(caps), None, masks=masks).numpy()
    assert got.shape == (B, T, te.VOCAB)
    _close(got, ref, 1e-5)


def test_forward_train_draws_dropout_from_the_generator(pair):
    _, _, tcap, pt = pair
    images, caps, _ = _batch(6)
    run = lambda seed: tcap.forward_train(pt, _t(images), _t(caps),  # noqa: E731
                                          torch.Generator().manual_seed(seed))
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    masks = taoa.draw_dropout_masks(torch.Generator().manual_seed(0), pt["decoder"], B,
                                    tcap.cfg, 0.5)
    assert masks.lstm[0].shape == (4, B, te.E + te.H) and masks.v_feat.shape == (B, 16, te.H)


def test_loss_gradients_with_dropout_match_jax(pair):
    jcap, pj, tcap, pt = pair
    images, caps, y = _batch(7)
    key = jax.random.PRNGKey(6)
    lj, gj = jax.value_and_grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps),
                                           jnp.asarray(y), key)
    masks = _jax_masks(key, pj, 0.5, B)
    lt, _, gt = tstep.value_and_grad(
        lambda p: (tcap.loss(p, _t(images), _t(caps), _t(y), None, masks=masks), None), pt)
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    leaves = te.tree_pairs(gj, gt)
    assert len(leaves) == len(jax.tree.leaves(gj))
    g_max = max(float(np.abs(np.asarray(a)).max()) for _, a, _ in leaves)
    for path, a, b in leaves:
        assert b.shape == a.shape, path
        if path == "/decoder/k_proj/bias":
            assert max(float(np.abs(np.asarray(a)).max()), float(b.abs().max())) <= 1e-6 * g_max
        else:
            _close(b.numpy(), np.asarray(a), 1e-4)


def _update_close(pj, pj1, pt1, gj):
    g_max = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(gj))
    checked = 0
    for (path, a0, g), (_, aj, at) in zip(te.tree_pairs(pj, gj), te.tree_pairs(pj1, _torch(pt1))):
        big = np.abs(np.asarray(g)) > 1e-3 * g_max
        if big.any():
            checked += 1
            a0 = np.asarray(a0)
            _close((at - a0)[big], (np.asarray(aj) - a0)[big], 1e-4)
    return checked


def _torch(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree)


def test_train_step_matches_jax_with_adam_beta1_09(pair):
    jcap, pj, tcap, pt = pair
    jcap = jcap.__class__(jcap.model_type, jcap.cfg.replace(drop_rate=0.0), jcap.vocab_size,
                          jcap.decoder)
    images, caps, y = _batch(8)
    opt_j, opt_t = jopt.make_optimizer("aoa", 1e-3), topt.make_optimizer("aoa", 1e-3)
    assert (opt_t.b1, opt_t.b2) == (0.9, 0.999)
    pj1, _, mj = j_make_train_step(jcap, opt_j, donate=False)(
        pj, opt_j.init(pj), jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y),
        jax.random.PRNGKey(0))
    tcap0 = tcap.__class__(tcap.model_type, tcap.cfg.replace(drop_rate=0.0), tcap.vocab_size,
                           tcap.decoder)
    pt1, st1, mt = tstep.make_train_step(tcap0, opt_t)(pt, opt_t.init(pt), _t(images), _t(caps),
                                                       _t(y), torch.Generator().manual_seed(0))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-6)
    gj = jax.grad(jcap.loss)(pj, jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y))
    assert _update_close(pj, pj1, pt1, gj) > 10


def test_lrp_finetune_step_matches_jax(pair):
    """One LRP-inference fine-tune step (drop_rate 0 on both sides): AOA's
    decoder LRP gives the relevance weights, VGG16's the CNN side."""
    jcap, pj, tcap, pt = pair
    jcap = jcap.__class__(jcap.model_type, jcap.cfg.replace(drop_rate=0.0), jcap.vocab_size,
                          jcap.decoder)
    tcap = tcap.__class__(tcap.model_type, tcap.cfg.replace(drop_rate=0.0), tcap.vocab_size,
                          tcap.decoder)
    images, caps, y = _batch(9)
    args = (jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y))
    wj = jft.lrp_weights(jcap, pj, args[0], jcap.forward_train(pj, args[0], args[1], None),
                         jnp.asarray(STOP), 1, 2, "mean")
    wt = tft.lrp_weights(tcap, pt, _t(images), tcap.forward_train(pt, _t(images), _t(caps)),
                         STOP, 1, 2, "mean")
    assert (np.asarray(wj) != 1.0).any()
    _close(wt.numpy() - 1.0, np.asarray(wj) - 1.0, 1e-4)
    opt_j, opt_t = jopt.make_optimizer("aoa", 1e-3), topt.make_optimizer("aoa", 1e-3)
    pj1, _, mj = jft.make_lrp_finetune_step(jcap, opt_j, STOP, 1, 2, "mean", donate=False)(
        pj, opt_j.init(pj), *args, jax.random.PRNGKey(0))
    gj = jax.grad(lambda q: jft.dual_loss(jcap.forward_train(q, args[0], args[1]), wj,
                                          args[2]))(pj)
    step = tft.make_lrp_finetune_step(tcap, opt_t, STOP, 1, 2, "mean")
    pt1, _, mt = step(pt, opt_t.init(pt), _t(images), _t(caps), _t(y),
                      torch.Generator().manual_seed(0))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-6)
    assert _update_close(pj, pj1, pt1, gj) > 10


def test_h5_round_trip_from_the_jax_writer(pair, tmp_path):
    """AOA's layout, with one refinement block, and the VGG16 encoder."""
    from lrp_imagecaptioning_tpu.models.weights_io import save_reference_checkpoint_h5
    from lrp_imagecaptioning_torch.models.weights_io import load_reference_checkpoint_h5

    jcap, pj, _, _ = pair
    pj = dict(pj, decoder=jaoa.init_params(jax.random.PRNGKey(8), te.VOCAB, jcap.cfg, 1))
    path = os.path.join(tmp_path, "aoa.h5")
    save_reference_checkpoint_h5(path, pj, "aoa", ENC, SMALL["layer_name"])
    got = load_reference_checkpoint_h5(path, "aoa", ENC, SMALL["layer_name"], device="cpu")
    leaves = te.tree_pairs(params_from_jax(pj, "cpu"), got)
    assert len(leaves) == len(jax.tree.leaves(pj)) and len(got["decoder"]["refine"]) == 1
    for path_, a, b in leaves:
        assert torch.equal(a, b), path_


def test_cli_train_and_explain_with_aoa(tmp_path, monkeypatch):
    """``cli.main`` train (one epoch) and explain with ``--model aoa`` on the
    mini-Flickr30k fixture."""
    from lrp_imagecaptioning_torch import cli
    from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k

    root = str(tmp_path / "mini")
    write_mini_flickr30k(root)
    monkeypatch.chdir(tmp_path)
    common = ["--dataset", "flickr30k", "--dataset-root", root, "--model", "aoa",
              "--batch-size", "4", "--device", "cpu"]
    for k, v in {"image_size": "32,32", "layer_name": "block3_conv1", "img_feature_length": "64",
                 "img_feature_dim": "256", "embedding_dim": "16", "hidden_dim": "16",
                 "sentence_length": "6", "words_min_occur": "1",
                 "rare_words_handling": "nothing"}.items():
        common += ["--set", f"{k}={v}"]
    cli.main(["train", *common, "--label", "aoa", "--epochs", "1"])
    ckpt = sorted((tmp_path / "results/flickr30k/training-results/aoa").glob("ckpt_*.npz"))
    assert ckpt
    image = sorted((tmp_path / "mini/Flickr30k_images").glob("*.jpg"))[0]
    cli.main(["explain", *common, "--weights", str(ckpt[-1]), "--image", str(image),
              "--method", "lrp", "--out", "ex"])
    assert list((tmp_path / "ex").rglob("*"))
