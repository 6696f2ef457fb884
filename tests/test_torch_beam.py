"""PyTorch port: beam search token-exact against the JAX package, including
an engineered logit tie (lowest index wins) and EOS kept just outside every
beam's top-K (never harvested)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.infer.beam import beam_search as j_beam  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.infer.beam import _top_k, beam_search as t_beam  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

E, H, D, L, V, T = 8, 16, 32, 4, 24, 6
SOS, EOS = 1, 2
DIMS = dict(embedding_dim=E, hidden_dim=H, img_feature_dim=D, img_feature_length=L)


@pytest.fixture(scope="module")
def models():
    jcap = j_build("adaptiveattention", JConfig(**DIMS, sentence_length=T), V)
    tcap = t_build("adaptiveattention", TConfig(**DIMS), V)
    dec = jcap.decoder.init_params(jax.random.PRNGKey(5), V, jcap.cfg)
    return jcap, tcap, dec


def _run_both(models, dec, feat, beam):
    jcap, tcap, _ = models
    tj, sj = j_beam(jcap, {"decoder": dec}, jnp.asarray(feat), SOS, EOS, beam, T)
    pt = {"decoder": params_from_jax(dec, "cpu")}
    tt, st = t_beam(tcap, pt, torch.from_numpy(feat), SOS, EOS, beam, T)
    return np.asarray(tj), tt.numpy(), np.asarray(sj), st.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("beam", [1, 2, 3])
def test_beam_search_token_exact(models, seed, beam):
    feat = np.random.default_rng(seed).normal(size=(3, L, D)).astype(np.float32) * 2
    tj, tt, sj, st = _run_both(models, models[2], feat, beam)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5)


def _biased_decoder(dec, bias):
    """Zero output kernel, chosen biases: logits are exactly ``bias`` in both
    frameworks, so ties are exact."""
    out = dict(dec)
    out["output"] = {"kernel": jnp.zeros_like(dec["output"]["kernel"]),
                     "bias": jnp.asarray(bias, jnp.float32)}
    return out


def test_beam_search_tie_breaks_to_lowest_index(models):
    bias = np.zeros(V, np.float32)
    bias[[9, 4, 17]] = 5.0          # three words tie exactly at the top
    bias[EOS - 1] = -10.0
    feat = np.random.default_rng(7).normal(size=(2, L, D)).astype(np.float32)
    tj, tt, _, _ = _run_both(models, _biased_decoder(models[2], bias), feat, 3)
    np.testing.assert_array_equal(tt, tj)
    assert (tt == 4 + 1).all()      # word 4 (1-based 5), the lowest tied index


def test_beam_search_eos_outside_topk_not_harvested(models):
    bias = np.full(V, -5.0, np.float32)
    bias[[3, 6, 11]] = [3.0, 2.5, 2.0]
    bias[EOS - 1] = 1.9             # 4th best word of every beam: outside top-3
    feat = np.random.default_rng(8).normal(size=(2, L, D)).astype(np.float32)
    tj, tt, sj, st = _run_both(models, _biased_decoder(models[2], bias), feat, 3)
    np.testing.assert_array_equal(tt, tj)
    assert (tt != EOS).all() and (tt > 0).all()   # best partial caption, full length
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    # and inside the top-3 it is harvested at step 0: caption = [EOS]
    bias[EOS - 1] = 2.2
    tj, tt, _, _ = _run_both(models, _biased_decoder(models[2], bias), feat, 3)
    np.testing.assert_array_equal(tt, tj)
    assert (tt[:, 0] == EOS).all()


def test_top_k_order_and_neg_inf():
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), float("-inf")]])
    vals, idx = _top_k(x, 5)
    assert idx.tolist() == [[1, 2, 0, 3, 4]]
    assert vals[0, :3].tolist() == [3.0, 3.0, 1.0]
