"""PyTorch port: LRP-inference fine-tuning against the JAX package on the CPU.

The size of tests/test_train.py (VGG16 cut at block2_conv1, 8x8 images,
E = H = 16, vocab 32, T = 6 or 7). ``lrp_weights`` runs the decoder LRP and
the f32 CNN LRP, whose divides by stab(z) amplify last-ulp differences, so
its scores are compared at 1e-4 of their scale; which (step, word) slots
carry a score is compared exactly. A whole step is compared as in
test_torch_train.py: loss at rel 1e-6, updates where |g| > 1e-3 max |g|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_tpu.train import lrp_finetune as jft  # noqa: E402
from lrp_imagecaptioning_tpu.train import optimizer as jopt  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.decoder_lrp import explain_word_adaptive  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.train import checkpoint as tckpt  # noqa: E402
from lrp_imagecaptioning_torch.train import lrp_finetune as tft  # noqa: E402
from lrp_imagecaptioning_torch.train import optimizer as topt  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_map  # noqa: E402

torch.set_num_threads(2)

KW = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
          img_feature_dim=128, sentence_length=6, batch_size=4, drop_rate=0.0)
VOCAB = 32
_CACHE = {}


def _caps():
    if not _CACHE:
        jcap = j_build("adaptiveattention", JConfig(**KW, image_size=(8, 8)), VOCAB)
        tcap = t_build("adaptiveattention", TConfig(**KW), VOCAB)
        pj = jcap.init_params(jax.random.PRNGKey(0))
        _CACHE["caps"] = (jcap, tcap, pj, params_from_jax(pj, "cpu"))
    return _CACHE["caps"]


def _t(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if not t.is_floating_point() else t


def _batch(seed, batch=4, steps=7):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, 8, 8, 3)).astype(np.float32)
    caps = rng.integers(0, VOCAB, size=(batch, steps)).astype(np.int32)
    y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(batch, steps))]
    y[1, -3:] = 0
    return images, caps, y


def _walk(a, b, fn, path=""):
    if isinstance(a, dict):
        for k in a:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    else:
        fn(path, np.asarray(a), b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b))


def _close_to_scale(got, ref, tol):
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max() / scale


# 1-based predictions: sample 0 has a stop word (5) at t=1 and EOS (2) at t=3,
# so t = 0 and 2 are explained; sample 1 has five valid words before its EOS,
# so max_words = 2 cuts three of them
CAPTIONS = np.array([[3, 5, 7, 2, 8, 9], [4, 6, 9, 10, 11, 2]])
STOP = np.zeros(VOCAB + 1, bool)
STOP[5] = True


def _logits():
    rng = np.random.default_rng(50)
    logits = rng.normal(size=(2, 6, VOCAB)).astype(np.float32)
    for b in range(2):
        for t in range(6):
            logits[b, t, CAPTIONS[b, t] - 1] = 5.0
    return logits


class _PP:
    vocab_size = VOCAB
    word_of = {tok: ("the" if tok == 5 else f"w{tok}") for tok in range(1, VOCAB + 1)}
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2


class _Provider:
    """Duck-typed provider over ready batches ((captions_in, images), y)."""

    caption_preprocessor = _PP()

    def __init__(self, batches):
        self.batches = batches
        self.calls = []

    def training_set(self, pad_to_length, skip_batches=0, drop_remainder=False):
        self.calls.append((pad_to_length, skip_batches, drop_remainder))
        for images, caps, y in self.batches[skip_batches:]:
            assert caps.shape[1] == pad_to_length
            yield (caps, images), y


def test_stop_word_table_matches_jax():
    pp = _PP()
    got = tft.stop_word_table(pp)
    np.testing.assert_array_equal(got, jft.stop_word_table(pp))
    assert got.tolist() == [False] + [tok == 5 for tok in range(1, VOCAB + 1)]
    assert tft.STOP_WORDS == jft.STOP_WORDS


@pytest.mark.parametrize("max_words", [None, 2, 6], ids=["all", "W2", "WT"])
@pytest.mark.parametrize("mode", ["mean", "pos_mean", "quantile"])
def test_lrp_weights_matches_jax(mode, max_words):
    jcap, tcap, pj, pt = _caps()
    images = np.random.default_rng(51).normal(size=(2, 8, 8, 3)).astype(np.float32)
    logits = _logits()
    ref = np.asarray(jax.jit(lambda p, im, lg: jft.lrp_weights(
        jcap, p, im, lg, jnp.asarray(STOP), 1, 2, mode, max_words=max_words))(
        pj, jnp.asarray(images), jnp.asarray(logits)))
    got = tft.lrp_weights(tcap, pt, _t(images), _t(logits), STOP, 1, 2, mode,
                          max_words=max_words).numpy()
    assert got.shape == ref.shape == (2, 6, VOCAB)
    scored = got != 1.0
    np.testing.assert_array_equal(scored, ref != 1.0)
    # the explained slots: t = 0, 2 of sample 0; t = 0..4 of sample 1, or its first 2
    # (pos_mean scores 0, weight 1, where a map has no positive part)
    want = [(0, 0), (0, 2), (1, 0), (1, 1)] + ([] if max_words == 2 else [(1, 2), (1, 3), (1, 4)])
    slots = sorted((int(b), int(t)) for b, t in zip(*np.nonzero(scored.any(-1))))
    assert set(slots) <= set(want) and (mode == "pos_mean" or slots == want)
    _close_to_scale(got - 1.0, ref - 1.0, 1e-4)


def test_lrp_weights_runs_without_grad():
    _, tcap, _, pt = _caps()
    images = _t(np.random.default_rng(52).normal(size=(2, 8, 8, 3)).astype(np.float32))
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), pt)
    w = tft.lrp_weights(tcap, params, images, _t(_logits()), STOP, 1, 2)
    assert not w.requires_grad


def test_explain_word_adaptive_positions_gathers_rows():
    _, tcap, _, pt = _caps()
    rng = np.random.default_rng(53)
    feat = _t(rng.normal(size=(3, 16, 128)).astype(np.float32))
    inputs = _t(rng.integers(0, VOCAB, size=(3, 6)))
    words = _t(rng.integers(0, VOCAB, size=(3, 6)))
    consts = tcap.prepare_consts(pt, feat)
    caches = tcap.decoder.forward_cached_from_inputs(pt["decoder"], consts, inputs, 16)
    full = explain_word_adaptive(pt["decoder"], consts, caches, words)
    pos = torch.tensor([[4, 0], [1, 5], [2, 2]])
    part = explain_word_adaptive(pt["decoder"], consts, caches, words.gather(1, pos), positions=pos)
    for f, p in zip(full, part):
        assert p.shape[:2] == (3, 2)
        ref = torch.stack([f[b, pos[b]] for b in range(3)])
        _close_to_scale(p.numpy(), ref.numpy(), 1e-6)


def test_dual_loss_matches_jax():
    rng = np.random.default_rng(54)
    logits = rng.normal(size=(2, 5, 9)).astype(np.float32)
    w = (1.0 + rng.normal(size=(2, 5, 9)) * 0.3).astype(np.float32)
    y = np.eye(9, dtype=np.float32)[rng.integers(0, 9, size=(2, 5))]
    y[0, 3:] = 0
    ref = float(jft.dual_loss(jnp.asarray(logits), jnp.asarray(w), jnp.asarray(y)))
    assert float(tft.dual_loss(_t(logits), _t(w), _t(y))) == pytest.approx(ref, rel=1e-6)


def _jax_steps(batches, lr, mode="mean"):
    jcap, _, pj, _ = _caps()
    opt = jopt.make_optimizer("adaptiveattention", lr)
    step = jft.make_lrp_finetune_step(jcap, opt, STOP, 1, 2, mode, donate=False)
    p, s, metrics, grads = pj, opt.init(pj), [], []
    for images, caps, y in batches:
        args = (jnp.asarray(images), jnp.asarray(caps), jnp.asarray(y))
        w = jft.lrp_weights(jcap, p, args[0], jcap.forward_train(p, args[0], args[1], None),
                            jnp.asarray(STOP), 1, 2, mode)
        grads.append(jax.grad(lambda q: jft.dual_loss(jcap.forward_train(q, args[0], args[1]),
                                                      w, args[2]))(p))
        p_new, s, m = step(p, s, *args, jax.random.PRNGKey(0))
        metrics.append(m)
        p = p_new
    return p, metrics, grads


def test_lrp_finetune_step_matches_jax():
    _, tcap, pj, pt = _caps()
    images, caps, y = _batch(55)
    lr = 1e-3
    pj1, (mj,), (gj,) = _jax_steps([(images, caps, y)], lr)
    opt = topt.make_optimizer("adaptiveattention", lr)
    step = tft.make_lrp_finetune_step(tcap, opt, STOP, 1, 2, "mean")
    assert set(step.phases) == {"predict", "lrp_weights", "update"}
    pt1, st1, mt = step(pt, opt.init(pt), _t(images), _t(caps), _t(y),
                        torch.Generator().manual_seed(0))
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-6)
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]), rel=1e-6)
    g_max = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(gj))
    checked = []

    def walk(a0, aj, at, g, path=""):
        if isinstance(a0, dict):
            for k in a0:
                walk(a0[k], aj[k], at[k], g[k], f"{path}/{k}")
            return
        big = np.abs(np.asarray(g)) > 1e-3 * g_max
        if big.any():
            checked.append(path)
            u_j = (np.asarray(aj) - np.asarray(a0))[big]
            u_t = (at.numpy() - np.asarray(a0))[big]
            _close_to_scale(u_t, u_j, 1e-4)

    walk(pj, pj1, pt1, gj)
    assert len(checked) > 10


def test_lrp_weights_max_words_covering_every_word_equals_all():
    """max_words = 5 covers every valid word (sample 1 has five): the weights
    equal those of every step, up to the rows' summation order."""
    _, tcap, _, pt = _caps()
    images = _t(np.random.default_rng(56).normal(size=(2, 8, 8, 3)).astype(np.float32))
    full = tft.lrp_weights(tcap, pt, images, _t(_logits()), STOP, 1, 2)
    part = tft.lrp_weights(tcap, pt, images, _t(_logits()), STOP, 1, 2, max_words=5)
    assert torch.equal(full != 1.0, part != 1.0)
    _close_to_scale((part - 1.0).numpy(), (full - 1.0).numpy(), 1e-6)


def test_lrp_finetuner_run_two_steps(tmp_path):
    """Two steps through the prefetcher, as two JAX steps on the same batches
    (drop_rate 0, so no dropout on either side), then a checkpoint."""
    _, tcap, pj, pt = _caps()
    batches = [_batch(70 + k, batch=2) for k in range(3)]
    provider = _Provider(batches)
    tuner = tft.LRPFinetuner(tcap, pt, provider, learning_rate=1e-6, device="cpu")
    metrics = tuner.run(save_idx=0, epoch_length=2, result_dir=str(tmp_path))
    assert provider.calls == [(7, 0, False)]
    _, mj, _ = _jax_steps(batches[:2], 1e-6)
    assert metrics["loss"] == pytest.approx(np.mean([float(m["loss"]) for m in mj]), rel=1e-5)
    assert metrics["accuracy"] == pytest.approx(np.mean([float(m["accuracy"]) for m in mj]),
                                                rel=1e-6)
    assert tuner.opt_state["count"] == 2
    path = tckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith(tckpt.ckpt_name(0, metrics["accuracy"]) + ".npz")
    params, opt_state = tckpt.restore_checkpoint(path, "cpu")
    _walk(tuner.params, params, lambda p, a, b: np.testing.assert_array_equal(b, a))
    assert opt_state["count"] == 2
    # the next chunk resumes past the batches the first one took
    tuner.run(save_idx=1, epoch_length=1, result_dir=str(tmp_path))
    assert provider.calls[-1] == (7, 1, False)
    assert tuner.opt_state["count"] == 3
