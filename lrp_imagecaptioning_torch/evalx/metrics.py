"""Caption metrics: BLEU-1..4, CIDEr(-D), ROUGE-L, METEOR, SPICE, BERTScore.

The port's own copy of the JAX package's ``evalx/metrics.py`` (pure Python), held to it
by the port's tests.

Equivalent of models/metrics.py:10-89, which wraps the external pycocoevalcap
package. Every reference scorer tokenizes both hypotheses and references with
PTBTokenizer first (metrics.py:22-23); this module does the same via
``evalx.ptb`` (Stanford-jar subprocess when a jar is present, Penn-Treebank
Python rules otherwise).

Scorers follow pycocoevalcap semantics exactly:

* BLEU  — corpus-level, clipped n-gram counts, 'closest' effective reference
  length (ties -> shorter), tiny/small smoothing, brevity penalty
  exp(1 - reflen/testlen) (pycocoevalcap bleu_scorer.py).
* CIDEr — CIDEr-D: tf-idf 1..4-gram clipped cosine with length gaussian
  (sigma=6), x10, mean over n then refs (pycocoevalcap cider_scorer.py).
* ROUGE — ROUGE-L, beta=1.2, with precision and recall each maxed
  INDEPENDENTLY across references before the F-measure
  (pycocoevalcap rouge.py::calc_score — not max-F-per-reference).
* METEOR — meteor-1.5.jar via the pycocoevalcap stdio protocol when the jar
  + paraphrase data are present (mirroring the reference's presence check,
  metrics.py:62-73); else a Python approximation (exact + Porter-stem
  stages, alpha=.9 beta=3 gamma=.5) that tracks but does not equal the jar.
* SPICE — spice jar subprocess when present; else a Python approximation
  (rule-parsed scene-graph tuples, exact SPICE F1 algebra — see
  ``spice_fallback.py``; the reference produces no SPICE number at all
  without its jar).
* BERT  — BERTScore via transformers when a local model is available; else 0
  (zero-egress environments cannot download weights).

All calculators share the reference's calling convention:
``calculate(id_to_prediction, id_to_references) -> {name: value}`` where the
dict values are ``[{'caption': str}, ...]``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import tempfile
import warnings
from collections import Counter, defaultdict

from .ptb import _find_jar, _java_bin, tokenize_lines


def _tokenize(s: str) -> list[str]:
    """PTB tokenization per the reference protocol (metrics.py:22-23)."""
    return tokenize_lines([s])[0]


def _pairs(id_to_prediction, id_to_references):
    """Tokenize the corpus with the PTB protocol, batched.

    ``tokenize_lines`` uses the CoreNLP jar when present (one subprocess for
    the whole batch, pycocoevalcap's strategy) and caches per line, so the
    six scorers calling this over the same corpus tokenize it once."""
    keys = sorted(id_to_prediction)
    hyp_lines = [id_to_prediction[k][0]["caption"] for k in keys]
    ref_lines = [[r["caption"] for r in id_to_references[k]] for k in keys]
    toks = tokenize_lines(hyp_lines + [s for rs in ref_lines for s in rs])
    hyps = toks[: len(hyp_lines)]
    it = iter(toks[len(hyp_lines):])
    refs = [[next(it) for _ in rs] for rs in ref_lines]
    return hyps, refs


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


class BLEU:
    def __init__(self, n: int = 4):
        self._n = n

    def calculate(self, id_to_prediction, id_to_references):
        hyps, refs = _pairs(id_to_prediction, id_to_references)
        small = 1e-9
        tiny = 1e-15
        correct = [0.0] * self._n
        total = [0.0] * self._n
        hyp_len = 0
        ref_len = 0
        for hyp, refset in zip(hyps, refs):
            hyp_len += len(hyp)
            # closest reference length; ties -> shorter (pycocoevalcap
            # bleu_scorer.py::_single_reflen option='closest')
            ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refset)[1]
            for n in range(1, self._n + 1):
                hc = _ngrams(hyp, n)
                maxref = Counter()
                for r in refset:
                    for g, c in _ngrams(r, n).items():
                        maxref[g] = max(maxref[g], c)
                correct[n - 1] += sum(min(c, maxref[g]) for g, c in hc.items())
                total[n - 1] += max(len(hyp) - n + 1, 0)
        bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / (hyp_len + tiny))
        out = {}
        logsum = 0.0
        for n in range(1, self._n + 1):
            p = (correct[n - 1] + tiny) / (total[n - 1] + small)
            logsum += math.log(p)
            out[f"Bleu_{n}"] = bp * math.exp(logsum / n)
        return out


class CIDEr:
    """CIDEr-D, n=1..4, sigma=6, x10 (pycocoevalcap cider_scorer.py)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma

    def calculate(self, id_to_prediction, id_to_references):
        hyps, refs = _pairs(id_to_prediction, id_to_references)
        # document frequency over reference sets
        doc_freq = [defaultdict(float) for _ in range(self._n)]
        for refset in refs:
            for n in range(self._n):
                seen = set()
                for r in refset:
                    seen |= set(_ngrams(r, n + 1))
                for g in seen:
                    doc_freq[n][g] += 1
        n_docs = max(len(refs), 1)
        log_ndocs = math.log(max(n_docs, 1))

        def vec(tokens):
            vs, norms = [], []
            for n in range(self._n):
                cnt = _ngrams(tokens, n + 1)
                v = {}
                norm = 0.0
                for g, c in cnt.items():
                    df = math.log(max(doc_freq[n][g], 1.0))
                    w = c * max(log_ndocs - df, 0.0)
                    v[g] = w
                    norm += w * w
                vs.append(v)
                norms.append(math.sqrt(norm))
            return vs, norms

        scores = []
        for hyp, refset in zip(hyps, refs):
            hv, hn = vec(hyp)
            score = 0.0
            for r in refset:
                rv, rn = vec(r)
                delta = len(hyp) - len(r)
                for n in range(self._n):
                    num = sum(min(hv[n].get(g, 0.0), rv[n].get(g, 0.0)) * rv[n].get(g, 0.0) for g in hv[n])
                    if hn[n] > 0 and rn[n] > 0:
                        s = num / (hn[n] * rn[n])
                    else:
                        s = 0.0
                    s *= math.exp(-(delta ** 2) / (2 * self._sigma ** 2))
                    score += s
            scores.append(score * 10.0 / (self._n * max(len(refset), 1)))
        return {"CIDEr": sum(scores) / max(len(scores), 1)}


class ROUGE:
    """ROUGE-L, beta=1.2. Precision and recall are maxed independently over
    the reference set BEFORE the F-measure (pycocoevalcap
    rouge.py::calc_score), which differs from max-F-per-reference whenever the
    best-precision and best-recall references differ."""

    BETA = 1.2

    @staticmethod
    def _lcs(a, b):
        m, n = len(a), len(b)
        if m == 0 or n == 0:
            return 0
        dp = [0] * (n + 1)
        for i in range(1, m + 1):
            prev = 0
            for j in range(1, n + 1):
                cur = dp[j]
                dp[j] = prev + 1 if a[i - 1] == b[j - 1] else max(dp[j], dp[j - 1])
                prev = cur
        return dp[n]

    def calculate(self, id_to_prediction, id_to_references):
        hyps, refs = _pairs(id_to_prediction, id_to_references)
        scores = []
        for hyp, refset in zip(hyps, refs):
            prec_max = 0.0
            rec_max = 0.0
            for r in refset:
                lcs = self._lcs(hyp, r)
                prec_max = max(prec_max, lcs / len(hyp) if hyp else 0.0)
                rec_max = max(rec_max, lcs / len(r) if r else 0.0)
            if prec_max != 0 and rec_max != 0:
                b2 = self.BETA ** 2
                score = (1 + b2) * prec_max * rec_max / (rec_max + b2 * prec_max)
            else:
                score = 0.0
            scores.append(score)
        return {"ROUGE_L": sum(scores) / max(len(scores), 1)}


class METEOR:
    """METEOR: jar subprocess when meteor-1.5.jar + paraphrase-en.gz exist
    (reference metrics.py:62-73 presence check), Python approximation
    otherwise.

    Jar path: pycocoevalcap meteor.py stdio protocol —
    ``java -jar -Xmx2G meteor-1.5.jar - - -stdio -l en -norm`` fed
    ``SCORE ||| ref1 ||| ... ||| hyp`` lines, then one
    ``EVAL ||| stat ...`` line; per-segment scores stream back followed by
    the aggregate.

    Python path: standard METEOR formula (alpha=0.9, beta=3.0, gamma=0.5)
    with exact, Porter-stem, synonym, and paraphrase matchers — METEOR
    1.5's full stage ladder. The jar's synonym stage needs WordNet; the
    fallback runs it against the vendored caption-domain synset table
    (``evalx/synonyms.py``, ~400 disjoint WordNet groups with morphy-style
    inflection normalization). The jar's paraphrase stage needs
    paraphrase-en.gz (~50 MB, no offline source here); the fallback runs a
    phrase-level stage 4 against the vendored caption-domain paraphrase
    table (``evalx/paraphrases.py``) — contiguous all-unmatched spans on
    both sides align when they sit in one phrase group, covering each
    side's span words (so precision and recall see different match counts
    when span lengths differ, as in the jar's phrase matching).
    ``synonyms=False`` / ``paraphrases=False`` reproduce the earlier-round
    configurations; with both stages inert the scores are bit-identical to
    the NLTK-pinned exact+stem core.

    Fallback fidelity (measured, experiments/METEOR_FALLBACK_BOUND.json):
    per-segment scores of the exact+stem core are differential-pinned to
    NLTK's independent meteor_score (same stages, same parameters) to
    < 1e-12 over a 144-segment perturbation corpus (60 cases in the in-tree
    differential, tests/test_meteor_differential.py), and the synonym stage
    is pinned to NLTK's wordnet stage run over the same vendored table
    (base-form corpus; NLTK's ref side is inflection-blind, ours
    normalizes both sides like the jar). The artifact records the MEASURED
    synonym-stage contribution on synonym-bearing caption pairs — round 4
    could only bound the missing stages by stem-stage proxy.
    """

    ALPHA, BETA_P, GAMMA = 0.9, 3.0, 0.5

    def __init__(self, jar: str | None = None, synonyms: bool = True,
                 paraphrases: bool = True):
        self._jar = jar if jar is not None else _find_jar("LRPIC_METEOR_JAR", "meteor-1.5.jar")
        if self._jar is not None:
            data = os.path.join(os.path.dirname(self._jar), "data", "paraphrase-en.gz")
            if not os.path.isfile(data):
                self._jar = None
        try:
            from nltk.stem.porter import PorterStemmer

            self._stem = PorterStemmer().stem
        except Exception:  # pragma: no cover
            self._stem = lambda w: w
        if synonyms:
            from .synonyms import lookup as _syn_lookup

            self._syn = _syn_lookup
        else:
            self._syn = None
        if paraphrases:
            from . import paraphrases as _para

            self._para = _para
        else:
            self._para = None

    # --- jar path (pycocoevalcap meteor.py protocol) ---

    def _calculate_jar(self, id_to_prediction, id_to_references):
        keys = sorted(id_to_prediction)
        hyps, refs = _pairs(id_to_prediction, id_to_references)
        proc = subprocess.Popen(
            [_java_bin(), "-jar", "-Xmx2G", self._jar, "-", "-", "-stdio", "-l", "en", "-norm"],
            cwd=os.path.dirname(self._jar),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, bufsize=1,
        )
        try:
            stats = []
            for hyp, refset in zip(hyps, refs):
                hyp_s = " ".join(hyp).replace("|||", "").replace("  ", " ")
                ref_s = " ||| ".join(" ".join(r) for r in refset)
                proc.stdin.write(f"SCORE ||| {ref_s} ||| {hyp_s}\n")
                proc.stdin.flush()
                stats.append(proc.stdout.readline().strip())
            proc.stdin.write("EVAL ||| " + " ||| ".join(stats) + "\n")
            proc.stdin.flush()
            for _ in keys:
                proc.stdout.readline()  # per-segment scores
            final = float(proc.stdout.readline().strip())
        finally:
            proc.stdin.close()
            proc.wait()
        return {"METEOR": final}

    # --- python path ---

    def _align(self, hyp, ref):
        """Greedy stage-wise alignment; returns (m_h, m_r, chunks) — the
        hypothesis-side and reference-side matched-word counts and the
        chunk count. Word-level matches contribute 1 to both sides; a
        phrase match (stage 4) contributes its span length on each side, so
        m_h != m_r exactly when a cross-length paraphrase fired (the jar's
        phrase matcher counts the same way).

        Tie-breaking for duplicate words follows NLTK's meteor_score
        (_match_enums: both lists walked in REVERSE, highest-index ref slot
        claimed first) so the fallback is differential-pinned bit-for-bit to
        that independent implementation
        (tests/test_meteor_differential.py). The jar's own resolver is a
        chunk-minimizing beam search, which can pick a different max-match
        alignment when duplicates allow several; the measured sensitivity of
        that ambiguity is recorded in experiments/METEOR_FALLBACK_BOUND.json.
        """
        m = len(hyp)
        match_of = [-1] * m
        used_ref = [False] * len(ref)
        stages = [lambda w: w, self._stem]
        if self._syn is not None:
            # synonym stage (NLTK/jar ordering: exact -> stem -> synonym):
            # two words match when they canonicalize into one vendored
            # synset group; both sides are inflection-normalized
            stages.append(self._syn)
        for stage in stages:
            hkey = [stage(w) for w in hyp]
            rkey = [stage(w) for w in ref]
            for i in range(m - 1, -1, -1):
                if match_of[i] >= 0:
                    continue
                for j in range(len(ref) - 1, -1, -1):
                    if not used_ref[j] and hkey[i] == rkey[j]:
                        match_of[i] = j
                        used_ref[j] = True
                        break
        # match blocks: (hyp_start, hyp_len, ref_start, ref_len). Word
        # matches are (i, 1, j, 1); phrase matches cover whole spans. The
        # phrase pass may RELEASE word matches internal to a winning phrase
        # pair (marking them -2), so word blocks are collected after it.
        blocks = []
        if self._para is not None:
            blocks += self._align_phrases(hyp, ref, match_of, used_ref)
        blocks += [(i, 1, j, 1) for i, j in enumerate(match_of) if j >= 0]
        blocks.sort()
        m_h = sum(b[1] for b in blocks)
        m_r = sum(b[3] for b in blocks)
        # a METEOR chunk is a maximal run of matches adjacent in BOTH the
        # hypothesis and the reference (Banerjee & Lavie 2005 §2.1; NLTK
        # meteor_score counts identically) — a skipped hyp word breaks the
        # chunk even when the ref indices stay consecutive. A phrase block
        # is internally contiguous on both sides, so it extends a chunk
        # exactly when its span starts adjoin the previous block's span ends.
        chunks = 0
        prev = None
        for hi, hl, rj, rl in blocks:
            if prev is None or hi != prev[0] or rj != prev[1]:
                chunks += 1
            prev = (hi + hl, rj + rl)
        return m_h, m_r, chunks

    def _align_phrases(self, hyp, ref, match_of, used_ref):
        """Stage 4 (paraphrase): greedily align contiguous hypothesis spans
        against contiguous reference spans when both sit in one vendored
        phrase group (``evalx.paraphrases``).

        The jar resolves ALL stages jointly (a beam search maximizing
        matched words, then minimizing chunks), so a phrase pair can win
        over word matches internal to it — "in front of" ~ "ahead of" fires
        even though "of" word-matches first. The sequential ladder mirrors
        that locally: a candidate span pair is admissible when every
        already-matched word inside either span is matched INTO the other
        span (no external alignment is disturbed), and it fires only when
        it covers strictly more words than the internal word matches it
        releases (the jar's max-matches criterion; on a tie the word
        alignment stands, so identical spans never re-fire). Longest
        hypothesis span first, left-to-right — residual resolution
        ambiguity vs the jar's beam is the same order-based kind covered by
        the recorded tie-break-sensitivity band. Claimed words are marked
        in ``match_of`` (-2) / ``used_ref``; returns the phrase blocks."""
        max_len = self._para.MAX_PHRASE_LEN
        lookup = self._para.lookup_phrase
        blocks = []
        for hl in range(min(max_len, len(hyp)), 0, -1):
            for hi in range(0, len(hyp) - hl + 1):
                hspan = range(hi, hi + hl)
                if any(match_of[i] == -2 for i in hspan):
                    continue  # already claimed by a longer phrase
                canon = lookup(hyp[hi:hi + hl])
                if canon is None:
                    continue
                hit = None
                for rl in range(min(max_len, len(ref)), 0, -1):
                    for rj in range(0, len(ref) - rl + 1):
                        rspan = range(rj, rj + rl)
                        if lookup(ref[rj:rj + rl]) != canon:
                            continue
                        # hyp-side internal matches must land inside rspan
                        internal = [i for i in hspan if match_of[i] >= 0]
                        if any(match_of[i] not in rspan for i in internal):
                            continue
                        # ref-side used words must be used FROM hspan
                        targets = {match_of[i] for i in internal}
                        if any(used_ref[j] and j not in targets for j in rspan):
                            continue
                        # max-matches: strict word-coverage gain required
                        if hl + rl <= 2 * len(internal):
                            continue
                        hit = (rj, rl)
                        break
                    if hit is not None:
                        break
                if hit is None:
                    continue
                rj, rl = hit
                for i in hspan:
                    match_of[i] = -2  # phrase-claimed: excluded from word blocks
                for j in range(rj, rj + rl):
                    used_ref[j] = True
                blocks.append((hi, hl, rj, rl))
        return blocks

    def calculate(self, id_to_prediction, id_to_references):
        if self._jar is not None:
            try:
                return self._calculate_jar(id_to_prediction, id_to_references)
            except Exception as e:  # pragma: no cover - jar env only
                warnings.warn(f"METEOR jar failed ({e}); falling back to Python approximation")
        hyps, refs = _pairs(id_to_prediction, id_to_references)
        scores = []
        for hyp, refset in zip(hyps, refs):
            best = 0.0
            for r in refset:
                m_h, m_r, chunks = self._align(hyp, r)
                if m_h == 0:
                    continue
                p = m_h / len(hyp)
                q = m_r / len(r)
                fmean = p * q / (self.ALPHA * p + (1 - self.ALPHA) * q)
                # frag denominator: the mean matched-word count. Reduces to
                # the classic chunks/matches whenever no cross-length
                # phrase fired (then m_h == m_r), preserving the NLTK pin.
                frag = chunks / ((m_h + m_r) / 2)
                pen = self.GAMMA * (frag ** self.BETA_P)
                best = max(best, fmean * (1 - pen))
            scores.append(best)
        return {"METEOR": sum(scores) / max(len(scores), 1)}


class SPICE:
    """SPICE: jar subprocess when a spice jar is present (pycocoevalcap
    spice.py protocol — input/output json files), else a Python
    approximation — rule-parsed scene-graph tuples scored with the exact
    SPICE F1 algebra (``evalx.spice_fallback``; the reference without its
    jar produces no SPICE number at all, metrics.py:62-73).

    Pass ``fallback=False`` for the reference's literal jarless behaviour
    (0 with a warning). Pass ``detailed=True`` for the jar's per-category
    breakdown (SPICE paper Table 2) as extra ``SPICE_Object`` /
    ``SPICE_Attribute`` / ``SPICE_Relation`` / ``SPICE_Color`` /
    ``SPICE_Count`` / ``SPICE_Size`` keys — each averaged over the images
    whose references CARRY that category (the jar's NaN-skip convention),
    from both the jar and the fallback."""

    # per-mode once-only warning flags (a process can legitimately use both
    # modes; each mode's distinct warning must fire on ITS first use)
    _warned_literal = False
    _warned_fallback = False

    CATEGORIES = ("Object", "Attribute", "Relation", "Color", "Count", "Size")

    def __init__(self, jar: str | None = None, fallback: bool = True,
                 detailed: bool = False):
        self._jar = jar if jar is not None else _find_jar("LRPIC_SPICE_JAR", "spice-1.0.jar")
        self._fallback = fallback
        self._detailed = detailed

    @classmethod
    def _aggregate(cls, per_image: list, detailed: bool) -> dict:
        """per_image: [{'All': f|None, 'Object': f|None, ...}] -> corpus
        dict. 'All' counts every image (None -> 0: no reference tuples at
        all); categories average only over images carrying the category."""
        alls = [s["All"] or 0.0 for s in per_image]
        out = {"SPICE": sum(alls) / max(len(alls), 1)}
        if detailed:
            for cat in cls.CATEGORIES:
                vals = [s[cat] for s in per_image if s.get(cat) is not None]
                out[f"SPICE_{cat}"] = sum(vals) / len(vals) if vals else 0.0
        return out

    def calculate(self, id_to_prediction, id_to_references):
        if self._jar is not None:
            try:
                return self._calculate_jar(id_to_prediction, id_to_references)
            except Exception as e:  # pragma: no cover - jar env only
                warnings.warn(f"SPICE jar failed ({e}); returning 0")
                return {"SPICE": 0.0}
        if not self._fallback:
            if not SPICE._warned_literal:
                warnings.warn("SPICE requires the external Java scene-graph parser; returning 0.")
                SPICE._warned_literal = True
            return {"SPICE": 0.0}
        if not SPICE._warned_fallback:
            warnings.warn(
                "SPICE jar not found; using the Python scene-graph "
                "approximation (exact tuple-F1 algebra over a rule-parsed "
                "graph — see evalx/spice_fallback.py for the deviation "
                "surface)."
            )
            SPICE._warned_fallback = True
        from .spice_fallback import spice_scores

        hyps, refs = _pairs(id_to_prediction, id_to_references)
        per_image = [spice_scores(h, rs) for h, rs in zip(hyps, refs)]
        out = self._aggregate(per_image, self._detailed)
        # marker key: persisted metrics files (test-metrics.yaml) must say
        # which path produced the number — jar scores and the approximation
        # are not comparable across environments
        out["SPICE_fallback"] = True
        return out

    def _calculate_jar(self, id_to_prediction, id_to_references):  # pragma: no cover - jar env only
        keys = sorted(id_to_prediction)
        hyps, refs = _pairs(id_to_prediction, id_to_references)
        payload = [
            {"image_id": str(k), "test": " ".join(h), "refs": [" ".join(r) for r in rs]}
            for k, h, rs in zip(keys, hyps, refs)
        ]
        with tempfile.TemporaryDirectory() as td:
            in_path = os.path.join(td, "input.json")
            out_path = os.path.join(td, "output.json")
            cache = os.path.join(td, "cache")
            os.makedirs(cache, exist_ok=True)
            with open(in_path, "w") as f:
                json.dump(payload, f)
            subprocess.run(
                [_java_bin(), "-jar", "-Xmx8G", self._jar, in_path,
                 "-cache", cache, "-out", out_path, "-subset", "-silent"],
                cwd=os.path.dirname(self._jar), check=True, capture_output=True,
            )
            with open(out_path) as f:
                results = json.load(f)

        def _f(item, cat):
            try:
                v = float(item["scores"][cat]["f"])
            except (KeyError, TypeError, ValueError):
                v = float("nan")
            if math.isnan(v):
                # NaN is expected for CATEGORIES with no reference signal
                # (skip-averaged), but a missing/NaN 'All' means corrupted
                # jar output — it would be silently averaged as 0
                if cat == "All":
                    warnings.warn(
                        f"SPICE jar emitted no 'All' score for image "
                        f"{item.get('image_id')!r}; counting it as 0")
                return None
            return v

        per_image = [
            {cat: _f(item, cat) for cat in ("All",) + self.CATEGORIES}
            for item in results
        ]
        return self._aggregate(per_image, self._detailed)


class BERT:
    """BERTScore over a local ``transformers`` model, else 0.

    Semantics follow the reference adapter (pycocoevalcap/bert/bert.py:3-50):
    every (hypothesis, reference) pair is flattened — the hypothesis repeated
    once per reference — scored individually, and the corpus value is the
    MEAN of per-pair F1s (NOT best-of-references). The scoring itself is
    BERTScore (Zhang et al., ICLR 2020) with bert_score.score's defaults as
    the reference calls it: greedy cosine matching of final-hidden-layer
    token embeddings, special tokens excluded, no idf weighting, no baseline
    rescaling. Implemented directly over transformers/torch because the
    ``bert_score`` pip package is an external dependency the reference does
    not vendor either.

    ``model_path``: local directory loadable by AutoTokenizer/AutoModel
    (no-download: this environment has no egress, and serving fleets pin
    local snapshots anyway). ``layer``: hidden-state index (default -1, the
    last layer). Without a model the metric degrades to 0 exactly like the
    reference without bert_score installed.
    """

    def __init__(self, model_path: str | None = None, layer: int = -1,
                 batch_size: int = 32):
        self._model_path = model_path
        self._layer = layer
        self._batch = batch_size
        self._tok = self._model = None

    def _load(self):
        if self._model is None:
            from transformers import AutoModel, AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(self._model_path)
            self._model = AutoModel.from_pretrained(self._model_path)
            self._model.eval()

    def _embed(self, sentences):
        """-> list of (n_real_tokens, H) unit-norm numpy arrays, special
        tokens dropped (bert_score strips them before matching). Real-token
        positions come from the attention mask itself, so left- and
        right-padding tokenizers both work."""
        import numpy as np_
        import torch

        out = []
        special = set(self._tok.all_special_ids)
        for i in range(0, len(sentences), self._batch):
            chunk = sentences[i:i + self._batch]
            enc = self._tok(chunk, return_tensors="pt", padding=True,
                            truncation=True)
            with torch.no_grad():  # scoped: never flips the process-global
                hidden = self._model(**enc, output_hidden_states=True
                                     ).hidden_states[self._layer]
            for b in range(len(chunk)):
                ids = enc["input_ids"][b]
                keep = [t for t in enc["attention_mask"][b].nonzero().flatten().tolist()
                        if int(ids[t]) not in special]
                e = hidden[b, keep].numpy().astype(np_.float64)
                norm = np_.linalg.norm(e, axis=-1, keepdims=True)
                out.append(e / np_.maximum(norm, 1e-12))
        return out

    @staticmethod
    def pair_f1(cand_emb, ref_emb) -> float:
        """Greedy-matching F1 of two unit-norm token-embedding matrices."""
        import numpy as np_

        if len(cand_emb) == 0 or len(ref_emb) == 0:
            return 0.0
        sim = cand_emb @ ref_emb.T                      # (nc, nr)
        p = float(np_.mean(sim.max(axis=1)))            # each cand -> best ref
        r = float(np_.mean(sim.max(axis=0)))            # each ref -> best cand
        if p + r == 0:
            return 0.0
        return 2 * p * r / (p + r)

    def calculate(self, id_to_prediction, id_to_references):
        if self._model_path is None:
            return {"BERTScore": 0.0}
        try:
            self._load()
        except Exception as e:
            warnings.warn(f"BERTScore model unavailable ({e}); returning 0")
            return {"BERTScore": 0.0}
        # reference flattening: one (hyp, ref) row per reference caption
        cands, refs = [], []
        for k in sorted(id_to_prediction):
            hyp = id_to_prediction[k][0]["caption"]
            for r in id_to_references[k]:
                cands.append(hyp)
                refs.append(r["caption"])
        if not cands:
            return {"BERTScore": 0.0}
        # embed each UNIQUE sentence once (a hypothesis repeats once per
        # reference in the flattening above — the transformer forward is the
        # dominant cost), then map pairs by string
        try:
            uniq = sorted(set(cands) | set(refs))
            emb = dict(zip(uniq, self._embed(uniq)))
            f1s = [self.pair_f1(emb[c], emb[r]) for c, r in zip(cands, refs)]
        except Exception as e:
            # degrade instead of killing the whole evaluation (the other
            # metrics' results are already computed by the caller): e.g. a
            # local model whose tokenizer cannot pad
            warnings.warn(f"BERTScore scoring failed ({e}); returning 0")
            return {"BERTScore": 0.0}
        return {"BERTScore": float(sum(f1s) / len(f1s))}


def default_metrics():
    """The reference's metric list (inference.py:31): BLEU(4), METEOR, CIDEr,
    ROUGE, SPICE."""
    return [BLEU(4), METEOR(), CIDEr(), ROUGE(), SPICE()]
