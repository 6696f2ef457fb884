"""PTB tokenization matching pycocoevalcap's PTBTokenizer protocol.

The port's own copy of the JAX package's ``evalx/ptb.py`` (pure Python), held to it
by the port's tests.

The reference tokenizes BOTH hypotheses and references with
pycocoevalcap/tokenizer/ptbtokenizer.py before every scorer
(reference models/metrics.py:22-23). That tokenizer shells out to
Stanford CoreNLP's ``edu.stanford.nlp.process.PTBTokenizer`` with
``-preserveLines -lowerCase`` and then drops a fixed punctuation list.

This module reproduces that pipeline:

* **Jar path** — when a Stanford CoreNLP jar is available (env var
  ``LRPIC_CORENLP_JAR`` or ``jars/stanford-corenlp-3.4.1.jar`` next to this
  file), run the exact same subprocess command as pycocoevalcap, so output is
  bit-identical to the reference protocol.
* **Python path** (default) — NLTK's ``TreebankWordTokenizer``, which
  implements the same Penn-Treebank ``tokenizer.sed`` rules (contraction
  splitting ``don't -> do n't``, possessives ``dog's -> dog 's``,
  ``-LRB-``/``-RRB-`` bracket escapes), followed by the identical
  lowercase + punctuation-drop steps.

Both paths share pycocoevalcap's PUNCTUATIONS list verbatim (it is protocol
data, not code). Note the faithful artifact: the jar lowercases BEFORE the
Python-side punctuation filter, so bracket escapes arrive as ``-lrb-`` /
``-rrb-`` and are NOT filtered (PUNCTUATIONS holds the uppercase forms) —
pycocoevalcap-tokenized corpora visibly contain ``-lrb-`` tokens. We
reproduce that ordering.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS — protocol constant
PUNCTUATIONS = frozenset(
    ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
     ".", "?", "!", ",", ":", "-", "--", "...", ";"]
)

_JAR_ENV = "LRPIC_CORENLP_JAR"


def _java_bin() -> str:
    """Java launcher for the jar paths; ``LRPIC_JAVA`` overrides so tests can
    substitute a protocol stub (no JRE ships in this environment)."""
    return os.environ.get("LRPIC_JAVA", "java")


def _find_jar(env_var: str, default_name: str) -> str | None:
    """Jar discovery convention shared by every jar-backed adapter
    (CoreNLP tokenizer here; METEOR/SPICE in metrics.py): explicit env var
    first, then ``jars/<name>`` next to this package."""
    p = os.environ.get(env_var)
    if p and os.path.isfile(p):
        return p
    here = os.path.dirname(os.path.abspath(__file__))
    cand = os.path.join(here, "jars", default_name)
    return cand if os.path.isfile(cand) else None


def _find_corenlp_jar() -> str | None:
    return _find_jar(_JAR_ENV, "stanford-corenlp-3.4.1.jar")


_nltk_tok = None
_CONTRACTIONS = ("'s", "'m", "'d", "'ll", "'re", "'ve", "n't")


def _lite_tokenize(line: str) -> list[str]:
    """Dependency-free Penn-Treebank-style fallback when nltk is absent.

    Covers the rules that matter for caption corpora: punctuation split off,
    contraction suffixes split (``don't -> do n't``), possessives split,
    parentheses converted to ``-LRB-``/``-RRB-``. Coarser than nltk's full
    sed-rule port on exotic input, but keeps every metric functional."""
    import re

    s = line.replace("(", " -LRB- ").replace(")", " -RRB- ")
    # split off punctuation runs (keep -LRB- style escapes intact)
    s = re.sub(r"([^\w\s'-])", r" \1 ", s)
    s = re.sub(r"(?<=\w)(n't)(?=\s|$)", r" \1", s, flags=re.IGNORECASE)
    s = re.sub(r"(?<=\w)('s|'m|'d|'ll|'re|'ve|')(?=\s|$)", r" \1", s,
               flags=re.IGNORECASE)
    return s.split()


def _python_tokenize_line(line: str) -> list[str]:
    global _nltk_tok
    if _nltk_tok is None:
        try:
            from nltk.tokenize import TreebankWordTokenizer

            _nltk_tok = TreebankWordTokenizer()
        except ImportError:  # metrics stay functional without nltk
            _nltk_tok = False
    if _nltk_tok is False:
        toks = _lite_tokenize(line)
    else:
        toks = _nltk_tok.tokenize(line, convert_parentheses=True)
    return [t for t in (tok.lower() for tok in toks) if t not in PUNCTUATIONS]


def _jar_tokenize_lines(jar: str, lines: list[str]) -> list[list[str]]:
    """Run Stanford PTBTokenizer exactly as pycocoevalcap does."""
    payload = "\n".join(s.replace("\n", " ") for s in lines)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(payload)
        path = f.name
    try:
        cmd = [
            _java_bin(), "-cp", jar, "edu.stanford.nlp.process.PTBTokenizer",
            "-preserveLines", "-lowerCase", path,
        ]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    finally:
        os.unlink(path)
    rows = out.split("\n")
    return [
        [w for w in rows[i].split() if w not in PUNCTUATIONS]
        for i in range(len(lines))
    ]


def ptb_tokenize(s: str) -> list[str]:
    """Tokenize one caption with the reference's PTB protocol (Python path)."""
    return _python_tokenize_line(s)


# line -> tokens memo shared by every scorer; corpus-scale (a few hundred
# thousand distinct caption strings at COCO size), cleared when it would
# grow past _CACHE_MAX to bound long-running services.
_token_cache: dict = {}
_CACHE_MAX = 1 << 20


def tokenize_lines(lines: list) -> list:
    """Batch PTB tokenization with a line-level cache.

    Uses the CoreNLP jar when one is present (ONE subprocess per batch of
    uncached lines — pycocoevalcap's own batching strategy), else the Python
    rules. The cache makes the 6 scorers' repeated tokenization of the same
    corpus cost one pass (pycocoevalcap instead tokenizes once up front)."""
    missing = [s for s in dict.fromkeys(lines) if s not in _token_cache]
    if missing:
        if len(_token_cache) + len(missing) > _CACHE_MAX:
            # evict, but KEEP the cached entries this call still reads at the
            # end — clearing them too made the final lookup KeyError once the
            # cache filled (a mixed old+new batch lost its old lines)
            keep = {s: _token_cache[s] for s in dict.fromkeys(lines)
                    if s in _token_cache}
            _token_cache.clear()
            _token_cache.update(keep)
        jar = _find_corenlp_jar()
        if jar is not None:
            token_lists = _jar_tokenize_lines(jar, missing)
        else:
            token_lists = [_python_tokenize_line(s) for s in missing]
        _token_cache.update(zip(missing, token_lists))
    return [_token_cache[s] for s in lines]


class PTBTokenizer:
    """pycocoevalcap-compatible interface:
    ``tokenize({id: [{'caption': str}, ...]}) -> {id: [str, ...]}`` where each
    output string is the space-joined token list."""

    def __init__(self, jar: str | None = None):
        self._jar = jar if jar is not None else _find_corenlp_jar()

    def tokenize(self, captions_for_image: dict) -> dict:
        keys = list(captions_for_image)
        lines, index = [], []
        for k in keys:
            for c in captions_for_image[k]:
                lines.append(c["caption"])
                index.append(k)
        if self._jar is not None:
            token_lists = _jar_tokenize_lines(self._jar, lines)
        else:
            token_lists = tokenize_lines(lines)  # shared cache, Python path
        out: dict = {k: [] for k in keys}
        for k, toks in zip(index, token_lists):
            out[k].append(" ".join(toks))
        return out
