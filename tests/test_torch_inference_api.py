"""PyTorch port: the inference API (``infer/api.py``) against the JAX
package's, on the mini-Flickr30k fixture.

The same params (the JAX init through ``weights.params_from_jax``) and the
same batches (the providers' batches are byte-equal,
tests/test_torch_provider.py) go through both. Captions are compared as
strings, exactly (the decoders' logits agree to ~1e-6 of their scale,
tests/test_torch_beam.py, far inside the gaps between candidates here), and
so the metric dicts are exactly equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.data.datasets import Flickr30kDataset as JDataset  # noqa: E402
from lrp_imagecaptioning_tpu.data.provider import DatasetProvider as JProvider  # noqa: E402
from lrp_imagecaptioning_tpu.infer import api as japi  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.data.datasets import Flickr30kDataset as TDataset  # noqa: E402
from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k  # noqa: E402
from lrp_imagecaptioning_torch.data.provider import DatasetProvider as TProvider  # noqa: E402
from lrp_imagecaptioning_torch.infer import api as tapi  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

KW = dict(batch_size=4, image_size=(32, 32), layer_name="block3_conv1", img_feature_length=64,
          img_feature_dim=256, embedding_dim=16, hidden_dim=16, sentence_length=6,
          words_min_occur=1, rare_words_handling="nothing")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini30k"))
    write_mini_flickr30k(root)
    jcfg, tcfg = JConfig(dataset_root=root, **KW), TConfig(dataset_root=root, **KW)
    jp, tp = JProvider(JDataset(jcfg), jcfg), TProvider(TDataset(tcfg), tcfg)
    out = {}
    for model_type in ("adaptiveattention", "gridTD"):
        jcap = j_build(model_type, jcfg, jp.vocab_size)
        pj = jcap.init_params(jax.random.PRNGKey(3))
        # the init's captions repeat one word for every image (the image
        # context outweighs the rest); with damped image projections, louder
        # words and a random output bias they vary by image and by step
        d = pj["decoder"]
        for name in ("image_features", "global_img_feature"):
            d[name]["kernel"] = d[name]["kernel"] * 0.01
        d["embedding"] = d["embedding"] * 10
        d["output"]["kernel"] = d["output"]["kernel"] * 10
        d["output"]["bias"] = np.random.default_rng(1).normal(
            size=d["output"]["bias"].shape).astype(np.float32) * 3
        out[model_type] = (jcap, t_build(model_type, tcfg, tp.vocab_size), pj,
                           params_from_jax(pj, "cpu"))
    return jp, tp, out


@pytest.mark.parametrize("kind", ["greedy", "beam3"])
@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_inference_matches_jax(setup, model_type, kind):
    jp, tp, caps = setup
    jcap, tcap, pj, pt = caps[model_type]
    if kind == "greedy":
        ji = japi.BasicInference(jcap, pj, jp, max_caption_length=6)
        ti = tapi.BasicInference(tcap, pt, tp, max_caption_length=6, device="cpu")
    else:
        ji = japi.BeamSearchInference(jcap, pj, jp, beam_size=3, max_caption_length=6)
        ti = tapi.BeamSearchInference(tcap, pt, tp, beam_size=3, max_caption_length=6,
                                      device="cpu")
    got_val = [c for c, _ in ti.predict_validation_set()]
    assert got_val == [c for c, _ in ji.predict_validation_set()]
    assert all(c.endswith("zeros") for c in got_val)
    m_t, p_t, r_t = ti.evaluate_test_set(include_prediction=True)
    m_j, p_j, r_j = ji.evaluate_test_set(include_prediction=True)
    assert p_t == p_j and r_t == r_j and m_t == m_j
    assert sorted(p_t) == ["1016887272.jpg", "1019077836.jpg"]   # the fixture's test split
    assert ti.evaluate_test_set() == m_j
    words = {w for c in got_val + [p[0]["caption"] for p in p_t.values()] for w in c.split()}
    assert len(words) >= 2   # words besides EOS (greedy: several; beam 3 on adaptive: one)
    assert np.isfinite(m_t["Bleu_1"]) and "SPICE" in m_t


def test_evaluation_keeps_each_image_once(setup):
    """A split with an image's five captions as five data scores the image
    once, with its first datum (inference.py:132-156)."""
    jp, tp, caps = setup
    jcap, tcap, pj, pt = caps["adaptiveattention"]
    ti = tapi.BasicInference(tcap, pt, tp, max_caption_length=6, device="cpu")
    ji = japi.BasicInference(jcap, pj, jp, max_caption_length=6)
    pairs = list(zip(["a zeros", "b zeros", "c zeros"], tp.dataset.training_set[:3]))
    jpairs = list(zip(["a zeros", "b zeros", "c zeros"], jp.dataset.training_set[:3]))
    m_t, p_t, r_t = ti._evaluate(pairs, include_prediction=True)
    m_j, p_j, r_j = ji._evaluate(jpairs, include_prediction=True)
    assert p_t == p_j == {pairs[0][1].img_filename: [{"caption": "a zeros"}]}
    assert r_t == r_j and m_t == m_j


def test_inference_asks_for_the_card_by_default(setup):
    jp, tp, caps = setup
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.BasicInference(caps["gridTD"][1], caps["gridTD"][3], tp)
