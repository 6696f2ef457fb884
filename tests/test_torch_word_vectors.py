"""PyTorch port: pretrained word vectors (``models/word_vectors.py``),
``Captioner.init_params(vocab_words=, word_vector_path=)`` and the Trainer's
``pretrained_word_vector``, against the JAX package.

The rows a vector file covers are the file's on both sides and must be equal.
The rows it does not cover keep a Glorot-uniform draw: the port draws it from
a ``torch.Generator`` (the same law, not ``jax.random``'s bits), so those rows
are held to the law's bound and to the generator's determinism, and the
parsers are compared under one deterministic initializer.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import torch_fixture  # noqa: E402
from lrp_imagecaptioning_tpu.models import word_vectors as jwv  # noqa: E402
from lrp_imagecaptioning_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k  # noqa: E402
from lrp_imagecaptioning_torch.models import word_vectors as twv  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(2)

GLOVE = "dog 1.0 2.0 3.0\ncat 4.0 5.0 6.0\nirrelevant 7.0 8.0 9.0\nbad 1.0 2.0\n"
FASTTEXT = "3 3\ndog 1.0 2.0 3.0\ncat 4.0 5.0 6.0\nowl 0.5 0.25 0.125\n"


def _const(value):
    return (lambda key, shape: np.full(shape, value, np.float32),
            lambda gen, shape: torch.full(shape, value))


@pytest.mark.parametrize("fmt", ["glove", "fasttext"])
def test_parsers_equal_jax(tmp_path, fmt):
    """One deterministic initializer on both sides: equal tables; the
    fastText header and a line of the wrong width are skipped."""
    p = tmp_path / "vec.txt"
    p.write_text(GLOVE if fmt == "glove" else FASTTEXT)
    vocab = ["dog", "unknownword", "cat", "owl", "bad"]
    j_init, t_init = _const(0.5)
    jcls, tcls = {"glove": (jwv.Glove, twv.Glove), "fasttext": (jwv.Fasttext, twv.Fasttext)}[fmt]
    ref = np.asarray(jcls(vocab, j_init, str(p), 3).vectorize_words(jax.random.PRNGKey(0)))
    got = tcls(vocab, t_init, str(p), 3).vectorize_words()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[0].numpy(), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(got[1].numpy(), [0.5, 0.5, 0.5])
    np.testing.assert_array_equal(got[4].numpy(), [0.5, 0.5, 0.5])   # "bad": wrong width
    if fmt == "fasttext":
        np.testing.assert_array_equal(got[3].numpy(), [0.5, 0.25, 0.125])


def test_fasttext_header_is_not_a_word(tmp_path):
    """A two-field first line is the header: a vocabulary word "3" is not read
    from it."""
    p = tmp_path / "ft.vec"
    p.write_text("3 3\ndog 1.0 2.0 3.0\n")
    _, t_init = _const(0.0)
    got = twv.Fasttext(["3", "dog"], t_init, str(p), 1).vectorize_words()
    np.testing.assert_array_equal(got.numpy(), [[0.0], [0.0]])


def test_init_embedding_hit_rows_equal_jax(tmp_path):
    p = tmp_path / "glove.txt"
    p.write_text(GLOVE)
    vocab = ["dog", "zzz", "cat", "yyy"]
    ref = jwv.init_embedding(jax.random.PRNGKey(0), vocab, 3, "glove", str(p))
    got = twv.init_embedding(torch.Generator().manual_seed(0), vocab, 3, "glove", str(p))
    np.testing.assert_array_equal(got[[0, 2]].numpy(), np.asarray(ref)[[0, 2]])
    limit = math.sqrt(6.0 / (4 + 3))
    assert float(got[[1, 3]].abs().max()) <= limit and float(got[[1, 3]].abs().max()) > 0


def test_init_embedding_without_file_is_glorot():
    gen = torch.Generator().manual_seed(3)
    table = twv.init_embedding(gen, ["a", "b", "c"] * 100, 40)
    ref = jwv.init_embedding(jax.random.PRNGKey(3), ["a", "b", "c"] * 100, 40)
    assert table.shape == np.asarray(ref).shape == (300, 40)
    limit = math.sqrt(6.0 / 340)
    assert float(table.abs().max()) <= limit
    # the same law: the mean and spread of U(-limit, limit)
    assert abs(float(table.mean())) < 0.05 * limit
    assert abs(float(table.std()) - limit / math.sqrt(3)) < 0.05 * limit
    again = twv.init_embedding(torch.Generator().manual_seed(3), ["a", "b", "c"] * 100, 40)
    torch.testing.assert_close(table, again, rtol=0, atol=0)
    with pytest.raises(ValueError, match="vector file"):
        twv.init_embedding(gen, ["a"], 4, "glove", None)


@pytest.mark.parametrize("model_type", ["adaptiveattention", "gridTD"])
def test_init_params_vocab_words(tmp_path, model_type):
    from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig
    from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build
    from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig

    p = tmp_path / "glove.txt"
    p.write_text("dog 1.0 0.0 0.0 0.0\ncat 0.0 1.0 0.0 0.0\n")
    small = dict(embedding_dim=4, hidden_dim=8, img_feature_length=4, img_feature_dim=12,
                 sentence_length=4, layer_name="block2_conv1", pretrained_word_vector="glove")
    vocab = ["dog", "zzz", "cat"]
    ref = j_build(model_type, JConfig(drop_rate=0.0, **small), 3).init_params(
        jax.random.PRNGKey(0), vocab_words=vocab, word_vector_path=str(p))
    cap = build_captioner(model_type, TConfig(**small), 3)
    params = cap.init_params(0, device="cpu", vocab_words=vocab, word_vector_path=str(p))
    emb = params["decoder"]["embedding"]
    np.testing.assert_array_equal(emb[[0, 2]].numpy(),
                                  np.asarray(ref["decoder"]["embedding"])[[0, 2]])
    assert float(emb[1].abs().max()) > 0
    # without vocab_words, or without the config's option: the plain init
    plain = cap.init_params(0, device="cpu")["decoder"]["embedding"]
    assert plain.shape == emb.shape and not torch.equal(plain[0], emb[0])
    off = build_captioner(model_type, TConfig(**dict(small, pretrained_word_vector=None)), 3)
    torch.testing.assert_close(off.init_params(0, device="cpu", vocab_words=vocab,
                                               word_vector_path=str(p))["decoder"]["embedding"],
                               plain, rtol=0, atol=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini30k"))
    write_mini_flickr30k(root)
    return root


@pytest.mark.parametrize("fmt", ["glove", "fasttext"])
def test_trainer_pretrained_word_vector_matches_jax(corpus, tmp_path, monkeypatch, fmt):
    """The Trainer seeds its embedding from the file at cfg.word_vector_path
    (an attribute the caller sets, as for the JAX Trainer): the covered rows
    equal the file's and the JAX Trainer's."""
    monkeypatch.chdir(tmp_path)
    from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig
    from lrp_imagecaptioning_tpu.data.datasets import Flickr30kDataset as JDataset
    from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig
    from lrp_imagecaptioning_torch.data.datasets import Flickr30kDataset as TDataset

    small = dict(torch_fixture.SMALL, pretrained_word_vector=fmt, dataset_root=corpus)
    rng = np.random.default_rng(0)
    words = ["dog", "cat", "green", "tree", "notinvocab"]
    vecs = rng.normal(size=(len(words), small["embedding_dim"])).astype(np.float32)
    lines = [f"{w} " + " ".join(repr(float(v)) for v in row) for w, row in zip(words, vecs)]
    if fmt == "fasttext":
        lines.insert(0, f"{len(words)} {small['embedding_dim']}")
    path = tmp_path / "vectors.txt"
    path.write_text("\n".join(lines) + "\n")
    tcfg, jcfg = TConfig(**small), JConfig(**small)
    tcfg.word_vector_path = jcfg.word_vector_path = str(path)
    t = Trainer("adaptiveattention", tcfg, TDataset(tcfg), eval_metrics=False, device="cpu")
    j = JTrainer("adaptiveattention", jcfg, JDataset(jcfg), eval_metrics=False)
    vocabs = t.provider.vocabs
    assert vocabs == j.provider.vocabs
    emb_t = t.params["decoder"]["embedding"].numpy()
    emb_j = np.asarray(j.params["decoder"]["embedding"])
    assert emb_t.shape == emb_j.shape == (len(vocabs), small["embedding_dim"])
    for w, row in zip(words[:4], vecs):
        i = vocabs.index(w)
        np.testing.assert_array_equal(emb_t[i], row)
        np.testing.assert_array_equal(emb_t[i], emb_j[i])
    limit = math.sqrt(6.0 / (len(vocabs) + small["embedding_dim"]))
    others = [i for i, w in enumerate(vocabs) if w not in words]
    assert 0 < np.abs(emb_t[others]).max() <= limit
