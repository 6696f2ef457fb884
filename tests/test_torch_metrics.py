"""PyTorch port: the caption metrics (``evalx``) against the JAX package.

The port keeps its own copies of the pure-Python scorers, so on the same
corpus every dict must be exactly equal. The corpus is the mini-Flickr30k
fixture's references with perturbed predictions (dropped and swapped words,
synonyms, the trailing EOS word the inference API appends). BERTScore runs a
tiny local model (as tests/test_bert_metric.py builds it): the two packages
embed with the same torch code, so their scores agree within 1e-6; padded
against unpadded scoring agrees within 1e-6 too, an f32 tolerance: the
padded batch's attention sums in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_tpu.evalx import metrics as jmetrics  # noqa: E402
from lrp_imagecaptioning_tpu.evalx import ptb as jptb  # noqa: E402
from lrp_imagecaptioning_torch.data.minifixture import _SCENES, _captions  # noqa: E402
from lrp_imagecaptioning_torch.evalx import metrics as tmetrics  # noqa: E402
from lrp_imagecaptioning_torch.evalx import ptb as tptb  # noqa: E402

_SYNONYMS = {"dog": "puppy", "car": "automobile", "grass": "lawn", "sitting": "seated"}
_COLOURS = ("red", "blue", "green", "yellow")


def _corpus(seed=0):
    """id -> predictions and id -> references over the fixture's 12 scenes,
    each prediction a reference perturbed by numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    preds, refs = {}, {}
    for stem, obj, colour, _ in _SCENES:
        caps = [c.lower().rstrip(" .") for c in _captions(obj, colour)]
        words = caps[int(rng.integers(len(caps)))].split()
        kind = int(rng.integers(4))
        if kind == 0 and len(words) > 3:
            del words[int(rng.integers(len(words)))]
        elif kind == 1:
            words = [_COLOURS[int(rng.integers(4))] if w in _COLOURS else w for w in words]
        elif kind == 2:
            words = [_SYNONYMS.get(w, w) for w in words]
        preds[stem + ".jpg"] = [{"caption": " ".join(words + ["zeros"])}]
        refs[stem + ".jpg"] = [{"caption": c + " zeros"} for c in caps]
    return preds, refs


METRICS = {
    "bleu": lambda m: m.BLEU(4),
    "cider": lambda m: m.CIDEr(),
    "rouge": lambda m: m.ROUGE(),
    "meteor": lambda m: m.METEOR(),
    "meteor-no-synonyms": lambda m: m.METEOR(synonyms=False),
    "meteor-no-paraphrases": lambda m: m.METEOR(paraphrases=False),
    "meteor-exact-stem": lambda m: m.METEOR(synonyms=False, paraphrases=False),
    "spice": lambda m: m.SPICE(),
    "spice-detailed": lambda m: m.SPICE(detailed=True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(METRICS))
def test_metric_dict_equals_jax(name, seed):
    preds, refs = _corpus(seed)
    got = METRICS[name](tmetrics).calculate(preds, refs)
    want = METRICS[name](jmetrics).calculate(preds, refs)
    assert got == want
    assert got and all(np.isfinite(v) for v in got.values())


def test_default_metrics_match_jax():
    preds, refs = _corpus(2)
    got, want = {}, {}
    for m in tmetrics.default_metrics():
        got.update(m.calculate(preds, refs))
    for m in jmetrics.default_metrics():
        want.update(m.calculate(preds, refs))
    assert got == want
    assert {"Bleu_4", "METEOR", "CIDEr", "ROUGE_L", "SPICE"} <= set(got)


_LINES = ["A man riding a horse on the beach.", "Two dogs don't chase the ball (quickly).",
          "The player's bat hits a ball, then he runs.", "A close-up of a red dog -- mid-air!",
          "There's a \"quoted\" word; and a semi-colon: here..."]


def test_tokenize_lines_matches_jax_and_lite_tracks_nltk():
    lines = _LINES + [r[0]["caption"] for r in _corpus(0)[1].values()]
    assert tptb.tokenize_lines(lines) == jptb.tokenize_lines(lines)
    for s in lines:
        assert tptb._lite_tokenize(s) == jptb._lite_tokenize(s)
        assert tptb._python_tokenize_line(s) == jptb._python_tokenize_line(s)
    pytest.importorskip("nltk")
    for s in _LINES[:3]:
        lite = [t for t in (x.lower() for x in tptb._lite_tokenize(s))
                if t not in tptb.PUNCTUATIONS]
        assert lite == tptb._python_tokenize_line(s)


_WORDS = ("a the cat dog man woman sat runs horse grass red blue street "
          "ball tree small big on in with").split()


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    """A 2-layer, 32-dim BertModel + WordPiece tokenizer saved locally."""
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("tinybert")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + _WORDS
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    tok = transformers.BertTokenizer(str(d / "vocab.txt"), do_lower_case=True)
    cfg = transformers.BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=64,
                                  max_position_embeddings=32)
    torch.manual_seed(0)
    transformers.BertModel(cfg).save_pretrained(str(d))
    tok.save_pretrained(str(d))
    return str(d)


def test_bert_matches_jax_and_padded_matches_unpadded(tiny_bert):
    pairs = [("a man with a dog", ["a man with a small dog", "red ball on grass"]),
             ("the cat runs", ["a cat sat on grass"]),
             ("a big red ball on the street", ["a ball", "the small tree"])]
    preds = {f"i{k}": [{"caption": h}] for k, (h, _) in enumerate(pairs)}
    refs = {f"i{k}": [{"caption": r} for r in rs] for k, (_, rs) in enumerate(pairs)}
    got = tmetrics.BERT(model_path=tiny_bert).calculate(preds, refs)["BERTScore"]
    want = jmetrics.BERT(model_path=tiny_bert).calculate(preds, refs)["BERTScore"]
    assert abs(got - want) <= 1e-6
    assert 0.0 < got <= 1.0
    # the corpus score embeds padded batches; each pair alone embeds unpadded
    b = tmetrics.BERT(model_path=tiny_bert)
    b._load()
    per_pair = [tmetrics.BERT.pair_f1(b._embed([h])[0], b._embed([r])[0])
                for h, rs in pairs for r in rs]
    assert abs(got - float(np.mean(per_pair))) <= 1e-6
    assert tmetrics.BERT().calculate(preds, refs) == {"BERTScore": 0.0}
