"""Python SPICE approximation: rule-parsed scene-graph tuple F1.

The port's own copy of the JAX package's ``evalx/spice_fallback.py`` (pure Python), held to it
by the port's tests.

The reference scores SPICE by shelling out to the SPICE jar — a Stanford
CoreNLP dependency parse turned into a scene graph (objects, attributes,
relations), scored as an F1 over the tuple sets (pycocoevalcap/spice;
Anderson et al., ECCV 2016). Without the jar the reference simply cannot
produce a SPICE number; this module gives the jarless environment an HONEST
APPROXIMATION instead of a hard 0, the same policy as the METEOR fallback
in ``evalx.metrics``.

What is exact here (SPICE-paper semantics, Anderson et al. §3):

* the tuple algebra — every object ``(o)``, attribute ``(o, a)`` and
  relation ``(o1, r, o2)`` of the parsed graph becomes one tuple;
* reference merging — the tuple sets of all reference captions are UNIONED
  into one graph before matching (§3.1);
* the score — set precision/recall over (deduplicated) tuples,
  ``F1 = 2PR/(P+R)`` per image, corpus value = mean of per-image F1
  (pycocoevalcap spice.py averages each image's ``All.f``).

What is approximated:

* the parser. The jar runs a full dependency parse; this module runs a
  caption-domain rule grammar over PTB tokens (closed-class lexicons for
  determiners/prepositions/copulas, a generated inflection table for ~120
  common caption verbs, morphology for the rest). Caption English is
  overwhelmingly ``NP (VERB) (PREP) NP ...`` chains, which the grammar
  covers, including: pre-head modifier runs ("young girl", "tennis court"),
  modifier coordination ("black and white dog"), subject coordination with
  relation distribution ("a man and a woman riding horses"), numeric
  modifiers as attributes ("two dogs" -> (dog, 2), the jar's convention),
  predicative copulas ("the bench is wooden"), relative clauses
  ("a dog that is running" -> (dog, run)), intransitive verb + preposition
  ("standing on top of X" -> (subj, stand) attribute + (subj, on top of, X)
  relation, the paper's Figure 2 decomposition), and transitive verbs
  ("riding a horse" -> (subj, ride, horse)). Round 5 extended the grammar
  to the previously-unmodeled miss set: possessives ("the man 's hat" ->
  (man, have, hat)), passives with agents ("a cake being cut by a woman"
  -> (woman, cut, cake)), agentless past participles attaching to the
  clause subject ("a picture of a horse taken at sunset" -> (picture,
  take)), existential "there is/are" (reduces to the copula + NP),
  partitive quantifiers ("one of the dogs" -> the head is "dogs"),
  appositives ("the goalie , a young man , blocks ..." parses the
  parenthetical standalone), comparatives ("larger than" as a relation),
  infinitive "to" after control verbs ("trying to catch X" -> (subj, try)
  + (subj, catch, X)), hyphenated compounds ("t-shirt"), and s-inflected
  verb forms as noun conjuncts ("food and drinks").
* matching. The jar matches tuple elements by lemma OR WordNet synset
  overlap; no WordNet data ships in this environment, so matching is by
  lemma plus the vendored caption-domain synset table
  (``evalx/synonyms.py``: ~400 disjoint single-word WordNet synsets,
  bike~bicycle, kid~child, sofa~couch, ...). Everything is lemmatized
  (plural irregulars, inflection-table verb lemmas) before comparison.

Deviations are therefore one-sided and parser-shaped: a construction the
grammar misreads changes that image's tuple set, while the scoring on top
of the tuple sets is exact. ``tests/test_spice.py`` pins the parser on
hand-derived scene graphs (including the SPICE paper's own example) and the
scorer on hand-computed F1s.

MEASURED deviation surface (experiments/spice_parser_coverage.py, artifact
SPICE_PARSER_COVERAGE.json): against a 63-caption gold corpus hand-derived
from the paper's rules — 3 captions deliberately drawn from constructions
STILL unmodeled after round 5 (object-gap relatives ("the ball that the
boy threw"), adjective-of complements ("full of apples"), PP-fronted
inversion ("on the table is a cake")) — the parser reaches tuple micro-F1
0.984 (all 60 modeled-construction captions parse to their exact gold
graphs, including equatives, raising verbs, and quantifier partitives
added late in round 5; the unmodeled tail accounts for every miss).
"""

from __future__ import annotations

from collections import OrderedDict

# ------------------------------------------------------------- lexicons

DETERMINERS = frozenset(
    "a an the this that these those some many several few each every all both "
    "no another other more most his her its their our my your".split()
)

# multi-word prepositions are merged before parsing, longest first
MULTI_PREPS = [
    ("on", "top", "of"),
    ("in", "front", "of"),
    ("next", "to"),
    ("close", "to"),
    ("out", "of"),
    ("off", "of"),
]

PREPOSITIONS = frozenset(
    "in on at by with near under over above below behind beside between "
    "against across along around atop inside outside onto into through "
    "towards toward up down off upon beneath underneath amid among past "
    "beyond during for from of to after before".split()
) | frozenset(" ".join(p) for p in MULTI_PREPS)

COPULAS = frozenset(
    "is are was were be being been am "
    # raising verbs link subject to predicate exactly like copulas for scene
    # content ("a man who APPEARS to be sleeping" -> (man, sleep))
    "appear appears appeared seem seems seemed".split()
)

CONJUNCTIONS = frozenset(["and", "or", ","])

# words the grammar skips entirely (pronoun subjects are rare in captions
# and carry no scene content; negation/adverbs do not form tuples).
# "there" covers the existential: "there are two boats" reduces to the
# copula + NP the grammar already parses. Bare "than" (not merged into a
# comparative) carries no tuple either.
SKIP = frozenset(
    "there it he she they them him who whom which while as not n't very "
    "really quite just also then so too than".split()
)

# animate caption subjects (lemma forms): used to attach participles to the
# clause subject across an intervening prepositional phrase
PERSON_NOUNS = frozenset(
    "man woman boy girl child person lady guy player worker rider surfer "
    "skier skateboarder snowboarder couple group crowd team family baby "
    "toddler teenager dog cat people men women".split()
)

# non-numeric quantifier nouns that act as partitives ("LOTS OF pots",
# "PLENTY OF room"): like "one of", the head is the NP after "of" and the
# quantifier contributes no tuple
QUANTIFIER_NOUNS = frozenset("lots lot plenty".split())

NUMBER_WORDS = {
    "one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
    "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
    "eleven": "11", "twelve": "12",
}

# base forms of common caption verbs; inflections are generated below
VERB_BASES = """
sit stand run walk jump play hold wear ride eat drink look watch fly swim
sleep lay lie hang carry catch throw kick hit drive pull push climb read
talk smile laugh wait perform dance sing cook cut feed pose lean rest graze
surf ski skate sail race chase bite lick sniff point reach touch cross pass
serve swing slide dive splash park cover fill top attach decorate paint
write type surround fence stack pile load land take make use work help
prepare display show gather travel move stop turn bend kneel crouch squat
stretch balance grab lift wave shake open close stare gaze glance smell
listen speak shout yell cheer clap celebrate compete practice train exercise
pitch bat dribble shoot score tackle dunk serve volley putt bowl fish hunt
herd plow mow dig plant pick harvest brush groom pet cuddle hug kiss
block dock try
""".split()

_IRREGULAR_VERB_FORMS = {
    "sat": "sit", "sitting": "sit", "stood": "stand", "ran": "run",
    "running": "run", "ate": "eat", "eaten": "eat", "drank": "drink",
    "drunk": "drink", "flew": "fly", "flown": "fly", "flies": "fly",
    "swam": "swim", "swimming": "swim", "swum": "swim", "slept": "sleep",
    "hung": "hang", "caught": "catch", "threw": "throw", "thrown": "throw",
    "drove": "drive", "driven": "drive", "hitting": "hit", "wore": "wear",
    "worn": "wear", "rode": "ride", "ridden": "ride", "held": "hold",
    "lying": "lie", "laid": "lay", "took": "take", "taken": "take",
    "made": "make", "cutting": "cut", "putting": "put", "put": "put",
    "getting": "get", "got": "get", "jogging": "jog", "shot": "shoot",
    "dug": "dig", "spoke": "speak", "spoken": "speak", "shook": "shake",
    "shaken": "shake", "drawn": "draw", "drew": "draw",
}

# forms that function as PASSIVE participles: regular "-ed" verbs plus the
# irregular (and base-identical) participles. Used to (a) detect the
# "(being) V-ed by AGENT" passive and (b) attach agentless participles to
# the clause subject ("a picture of a horse TAKEN at sunset" -> picture).
_PAST_PARTICIPLES = frozenset(
    "cut put held hung made shot taken worn thrown driven ridden eaten "
    "flown swum drunk caught drawn given broken written hidden torn built "
    "left found".split()
)

# common non-verb words that would otherwise match the generic "-ed" rule
_NOT_VERBS = frozenset(
    "hundred naked wicked rugged sacred crooked jagged ragged beloved "
    "speed seed breed bleed".split()
)

_VOWELS = set("aeiou")


def _inflections(base: str) -> list[str]:
    """Regular -s/-es/-ed/-ing forms of a verb base."""
    forms = []
    if base.endswith(("s", "x", "z", "ch", "sh")):
        forms.append(base + "es")
    elif base.endswith("y") and base[-2] not in _VOWELS:
        forms.append(base[:-1] + "ies")
        forms.append(base[:-1] + "ied")
    else:
        forms.append(base + "s")
    if base.endswith("e"):
        forms.append(base + "d")
        forms.append(base[:-1] + "ing")
    else:
        forms.append(base + "ed")
        forms.append(base + "ing")
        # consonant doubling (CVC, not w/x/y): pat -> patted/patting
        if (
            len(base) >= 3
            and base[-1] not in _VOWELS | set("wxy")
            and base[-2] in _VOWELS
            and base[-3] not in _VOWELS
        ):
            forms.append(base + base[-1] + "ed")
            forms.append(base + base[-1] + "ing")
    return forms


def _build_verb_lemmas() -> dict:
    table = {}
    for base in VERB_BASES:
        table[base] = base
        for form in _inflections(base):
            table.setdefault(form, base)
    table.update(_IRREGULAR_VERB_FORMS)
    return table


VERB_LEMMA = _build_verb_lemmas()

_IRREGULAR_PLURALS = {
    "men": "man", "women": "woman", "children": "child", "people": "person",
    "feet": "foot", "teeth": "tooth", "geese": "goose", "mice": "mouse",
    "sheep": "sheep", "deer": "deer", "fish": "fish", "leaves": "leaf",
    "shelves": "shelf", "knives": "knife", "wolves": "wolf",
    "scissors": "scissors", "glasses": "glasses", "pants": "pants",
    "shorts": "shorts", "jeans": "jeans", "stairs": "stairs",
    "buses": "bus", "lenses": "lens",
}


def _looks_plural(word: str) -> bool:
    return word in _IRREGULAR_PLURALS or (
        word.endswith("s") and not word.endswith(("ss", "us", "is")) and len(word) > 3
    )

# the jar matches tuple elements by WordNet synset overlap; the vendored
# caption-domain synset table (evalx/synonyms.py, ~400 disjoint groups)
# supplies that equivalence offline. Replaces round 4's 12-pair seed table.
from .synonyms import SYNSET_GROUPS as SYNONYM_GROUPS  # noqa: F401  (re-export)
from .synonyms import canonical as _table_canonical


def noun_lemma(word: str) -> str:
    if word in _IRREGULAR_PLURALS:
        return _IRREGULAR_PLURALS[word]
    if word in VERB_LEMMA and word.endswith("ing"):
        # gerund used nominally keeps its verb lemma ("skiing" etc.)
        return VERB_LEMMA[word]
    if word.endswith("ies") and len(word) > 4:
        return word[:-3] + "y"
    if word.endswith(("sses", "xes", "zes", "ches", "shes")) and len(word) > 4:
        return word[:-2]
    # NOTE: plain "-ses" strips only the final s (horses/houses/noses; the
    # rarer bus/lens class is covered by irregulars)
    if word.endswith("s") and not word.endswith(("ss", "us", "is")) and len(word) > 3:
        return word[:-1]
    return word


def canonical(lemma: str) -> str:
    """Map a lemma through the synset table (the matching equivalence)."""
    return _table_canonical(lemma)


# ------------------------------------------------------------- parsing


def _merge_multiword_preps(tokens: list) -> list:
    out = []
    i = 0
    while i < len(tokens):
        for phrase in MULTI_PREPS:
            n = len(phrase)
            if tuple(tokens[i : i + n]) == phrase:
                out.append(" ".join(phrase))
                i += n
                break
        else:
            out.append(tokens[i])
            i += 1
    return out


def _is_verb(word: str) -> bool:
    if word in VERB_LEMMA:
        return True
    if word in _NOT_VERBS:
        return False
    # unknown -ing / -ed forms are verbs/participles in caption position
    if word.endswith("ing") and len(word) > 4:
        return True
    return word.endswith("ed") and len(word) > 4 and not word.endswith("eed")


def _is_past_participle(word: str) -> bool:
    return word in _PAST_PARTICIPLES or (word.endswith("ed") and _is_verb(word))


def _verb_lemma(word: str) -> str:
    if word in VERB_LEMMA:
        return VERB_LEMMA[word]
    if word.endswith("ied") and len(word) > 4:
        return word[:-3] + "y"  # tried -> try
    stem = word[:-3] if word.endswith("ing") else word[:-2]
    if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
        return stem[:-1]  # hugging/hugged -> hug
    return stem


def _is_prep(word: str) -> bool:
    """Prepositions plus merged comparative/equative relations
    ("larger than", "as big as")."""
    return (
        word in PREPOSITIONS
        or word.endswith(" than")
        or (word.startswith("as ") and word.endswith(" as"))
    )


def _is_wordlike(t: str) -> bool:
    """Tokens that may enter an NP: alnum, merged multi-word units, and
    hyphenated compounds ("t-shirt", "fire-truck" — PTB keeps the hyphen)."""
    if t.isalnum() or " " in t:
        return True
    if "-" in t:
        segs = t.split("-")
        return len(segs) > 1 and all(s.isalnum() for s in segs)
    return False


def _merge_comparatives(toks: list) -> list:
    """"larger than" / "as big as" -> one relation token, treated
    prepositionally ("a dog LARGER THAN its owner" -> (dog, larger than,
    owner); "a dog AS BIG AS a wolf" -> (dog, as big as, wolf))."""
    out = []
    i = 0
    n = len(toks)
    while i < n:
        w = toks[i]
        if (
            i + 1 < n
            and toks[i + 1] == "than"
            and ((w.endswith("er") and len(w) > 4) or w in ("more", "less"))
        ):
            out.append(w + " than")
            i += 2
        elif (
            w == "as"
            and i + 2 < n
            and toks[i + 2] == "as"
            and _np_only_word(toks[i + 1])
            and toks[i + 1] not in DETERMINERS
        ):
            out.append(f"as {toks[i + 1]} as")
            i += 3
        else:
            out.append(w)
            i += 1
    return out


def _np_only_word(w: str) -> bool:
    """A word that can live inside a pure NP (appositive candidate)."""
    if w in DETERMINERS:
        return True
    return (
        _is_wordlike(w)
        and " " not in w
        and not _is_prep(w)
        and w not in COPULAS
        and w not in CONJUNCTIONS
        and w not in SKIP
        and not _is_verb(w)
    )


def _split_appositives(toks: list):
    """Splice out ", DET mod* head ," appositive segments.

    "the goalie , a young man , blocks the shot": the parenthetical NP
    describes the preceding head but must not hijack the clause subject —
    it parses standalone ((man,), (man, young)) while the main clause keeps
    (goalie, block, shot). Returns (main_tokens, [segment_tokens...])."""
    main, segs = [], []
    i, n = 0, len(toks)
    while i < n:
        if toks[i] == "," and main and i + 1 < n and toks[i + 1] in DETERMINERS:
            j = i + 1
            seg = []
            while j < n and toks[j] != ",":
                seg.append(toks[j])
                j += 1
            if (
                j < n
                and seg
                and any(w not in DETERMINERS for w in seg)
                and all(_np_only_word(w) for w in seg)
            ):
                segs.append(seg)
                i = j + 1  # drop the segment and both commas
                continue
        main.append(toks[i])
        i += 1
    return main, segs


def parse_tuples(tokens: list) -> set:
    """Parse one PTB-tokenized caption into its scene-graph tuple set.

    Tuples are ``(obj,)``, ``(obj, attr)`` and ``(subj, rel, obj)`` with all
    elements lemmatized. See the module docstring for the grammar.
    """
    toks = _merge_multiword_preps(
        [t.lower() for t in tokens if _is_wordlike(t) or t in (",", "'s", "'")]
    )
    toks = _merge_comparatives(toks)
    toks, appositives = _split_appositives(toks)
    tuples = OrderedDict()  # ordered set
    for seg in appositives:
        for tup in _parse_clause(seg):
            tuples[tup] = None
    for tup in _parse_clause(toks):
        tuples[tup] = None
    return set(tuples)


def _parse_clause(toks: list) -> OrderedDict:
    tuples = OrderedDict()  # ordered set

    def add(tup):
        tuples[tup] = None

    subjects: list = []  # heads of the most recent completed NP(s)
    clause_subjects: list = []  # heads of the caption's FIRST NP
    pending_verb: str | None = None
    pending_prep: str | None = None
    pending_poss: list = []  # possessor heads awaiting their head NP
    passive: tuple | None = None  # (verb, patients) awaiting the "by" agent
    after_copula = False
    det_before = False  # a determiner immediately precedes the cursor

    def actors():
        """Verb attachment: captions hang participles off the clause
        subject when it is animate ("a man in a white shirt HOLDING a bat"
        -> man), off the nearest NP otherwise ("a plate with a fork RESTING
        on it" -> fork)."""
        if clause_subjects and any(s in PERSON_NOUNS for s in clause_subjects):
            return clause_subjects
        return subjects

    i = 0
    n = len(toks)
    while i < n:
        w = toks[i]
        if w in DETERMINERS:
            det_before = True
            i += 1
            continue
        if w in ("'s", "'"):  # stray possessive marker (no preceding NP)
            det_before = False
            i += 1
            continue
        if w in SKIP or w in CONJUNCTIONS:
            det_before = False
            i += 1
            continue
        if w in COPULAS:
            after_copula = True
            det_before = False
            i += 1
            continue
        if _is_prep(w):
            pending_prep = w
            det_before = False
            i += 1
            continue
        if _is_verb(w) and not _np_starts_here(toks, i, w):
            lemma = _verb_lemma(w)
            if pending_prep == "to":
                pending_prep = None  # infinitive marker: "trying TO catch"
            nxt = _next_content(toks, i + 1)
            # past participles hang off the clause subject even when inanimate
            # ("a picture of a horse TAKEN at sunset" -> picture); progressives
            # keep the animacy rule
            participle = _is_past_participle(w)
            targets = clause_subjects if participle and clause_subjects else actors()
            if nxt == "by" and participle:
                # passive: "a cake (being) cut BY a woman" -> the "by" NP is
                # the agent of a reversed relation, not a location
                passive = (lemma, list(targets))
            elif nxt is None or _is_prep(nxt) or nxt in COPULAS or nxt in CONJUNCTIONS or nxt in SKIP:
                # no direct object: the verb becomes an attribute of its
                # subject(s) and a following prep carries the relation
                # (the paper's "(girl, standing) + (girl, on-top-of, court)"
                # decomposition)
                for s in targets:
                    add((s, lemma))
                if nxt is not None and _is_prep(nxt):
                    subjects = targets
            else:
                pending_verb = lemma
            after_copula = False
            det_before = False
            i += 1
            continue

        # here: a content word — start of an NP (modifier* head) or a
        # predicative adjective after a copula
        was_after_det = det_before
        det_before = False
        np_words, i = _consume_np(toks, i)
        if not np_words:
            i += 1
            continue
        if (
            all(x in NUMBER_WORDS or x.isdigit() or x in QUANTIFIER_NOUNS
                for x in np_words)
            and i < n
            and toks[i] == "of"
        ):
            # partitive quantifier: "ONE OF the dogs is asleep", "LOTS OF
            # pots" — the head is the NP after "of"; the quantifier itself
            # contributes no tuple. Pending verb/prep survive to attach to
            # the real head NP.
            i += 1
            continue
        if after_copula and not was_after_det and len(np_words) == 1:
            # "the bench is wooden" -> predicative attribute ("is running"
            # was already handled by the verb branch; "is a table" arrives
            # with a preceding determiner and parses as an object NP)
            for s in subjects:
                add((s, _attr_lemma(np_words[0])))
            after_copula = False
            continue
        after_copula = False

        groups = _np_heads_attrs(np_words)
        heads = [h for h, _ in groups]
        for h, attrs in groups:
            add((h,))
            for a in attrs:
                add((h, a))
        if i < n and toks[i] in ("'s", "'"):
            # possessive: "the man 'S hat" -> the possessor got its object
            # tuple above; the (man, have, hat) relation lands when the
            # possessed head NP arrives, and any pending verb/prep attach to
            # that head too ("holding the man 's hat" -> (subj, hold, hat))
            pending_poss.extend(heads)
            i += 1
            continue
        for s in pending_poss:
            for h in heads:
                add((s, "have", h))
        pending_poss = []
        if passive is not None and pending_prep == "by":
            vb, patients = passive
            for h in heads:
                for p in patients:
                    add((h, vb, p))
        elif pending_verb is not None:
            # transitive verbs act for the clause subject(s): "a man in a
            # white shirt HOLDING a bat" -> (man, hold, bat)
            rel = pending_verb + (" " + pending_prep if pending_prep else "")
            for s in actors():
                for h in heads:
                    add((s, rel, h))
        elif pending_prep is not None:
            for s in subjects:
                for h in heads:
                    add((s, pending_prep, h))
        passive = None
        pending_verb = pending_prep = None
        subjects = heads
        if not clause_subjects:
            clause_subjects = heads
    # trailing verb with no object: "a dog running" at caption end was
    # handled in the loop; nothing to flush
    return tuples


def _next_content(toks, i):
    """Next token that is not a determiner/skip word, else None."""
    while i < len(toks):
        if toks[i] not in DETERMINERS and toks[i] not in SKIP:
            return toks[i]
        i += 1
    return None


def _np_starts_here(toks, i, w):
    """A known-verb form can still head an NP ("a running dog" modifier or
    the gerund-subject "skiing is fun"); treat a verb form as NP content
    only when it is caption-initial with no subject yet or directly follows
    a determiner (so "a standing man" keeps standing as a modifier)."""
    if i == 0:
        return not w.endswith("ing") or _next_is_content_noun(toks, i + 1)
    prev = toks[i - 1]
    if prev in DETERMINERS:
        # determiner directly before: part of an NP ("a running dog");
        # but "a dog is running" never reaches here with prev==DET
        return True
    if (
        _is_prep(prev)
        and w.endswith("ing")
        and i + 1 < len(toks)
        and toks[i + 1] not in DETERMINERS
        and _next_is_content_noun(toks, i + 1)
    ):
        return True  # "by running water" — bare participle modifier
    return False


def _noun_conjunct(toks, j):
    """The conjunct after and/comma: a content noun, or an s-inflected verb
    form used nominally ("food and DRINKS") — a plural-looking known verb
    form with nothing NP-ish after it reads as a noun conjunct."""
    if _next_is_content_noun(toks, j):
        return True
    if j >= len(toks):
        return False
    w = toks[j]
    if not (w in VERB_LEMMA and _looks_plural(w)):
        return False
    nxt = toks[j + 1] if j + 1 < len(toks) else None
    return (
        nxt is None or _is_prep(nxt) or nxt in COPULAS or nxt in CONJUNCTIONS
        or nxt in SKIP or nxt == ","
    )


def _next_is_content_noun(toks, i):
    if i >= len(toks):
        return False
    w = toks[i]
    return (
        w not in DETERMINERS and not _is_prep(w) and w not in COPULAS
        and w not in CONJUNCTIONS and w not in SKIP and not _is_verb(w)
    )


def _consume_np(toks, i):
    """Collect the modifier*/head run starting at i, handling modifier and
    head coordination with "and"/commas. Stops at preps, copulas, known
    verb forms (unless NP-initial after a determiner), and skip words.
    Returns (words, next_index); coordination commas/and are kept as
    markers."""
    words = []
    n = len(toks)
    while i < n:
        w = toks[i]
        if w in CONJUNCTIONS:
            # include coordination only if another NP follows (allowing the
            # conjunct its own determiner: "a man and a woman")
            j = i + 1
            if j < n and toks[j] in DETERMINERS:
                j += 1
            if words and j < n and _noun_conjunct(toks, j):
                words.append("&")
                i += 1
                continue
            break
        if (
            w in DETERMINERS
            and words
            and words[-1] == "&"
        ):
            # "a man and a woman": the conjunct's own determiner marks HEAD
            # coordination (vs "black and white dog" modifier coordination)
            words[-1] = "&&"
            i += 1
            continue
        if _is_prep(w) or w in COPULAS or w in SKIP or w in DETERMINERS:
            break
        if _is_verb(w) and words and words[-1] not in ("&", "&&"):
            # "a dog running" — an INFLECTED verb form ends the NP. A bare
            # base form is only a verb after a plural ("two men hold
            # umbrellas"); after a singular modifier it is a noun head
            # ("a baseball bat", "a park bench")
            pending = [x for x in words if x not in ("&", "&&")]
            headless = all(x in NUMBER_WORDS or x.isdigit() for x in pending)
            if headless:
                pass  # "two drinks" — the NP still needs its head noun
            elif w not in VERB_BASES or _looks_plural(words[-1]):
                break
        if not _is_wordlike(w):
            break
        words.append(w)
        i += 1
    while words and words[-1] in ("&", "&&"):
        words.pop()
    return words, i


def _np_heads_attrs(np_words):
    """Split an NP word run into ``[(head, [attrs]), ...]`` groups.

    "black & white dog"    -> [(dog, [black, white])]
    "man && woman"         -> [(man, []), (woman, [])]
    "glasses && red hat"   -> [(glasses, []), (hat, [red])]
    "young girl"           -> [(girl, [young])]
    "two dogs"             -> [(dog, [2])]

    "&&" (the conjunct carried its own determiner) forces head
    coordination; a bare "&" run is modifier coordination when every
    earlier conjunct is a single word and the final one carries the head
    ("black and white dog"), head coordination otherwise ("a man and dog").
    """
    groups = [[]]
    det_marked = False
    for w in np_words:
        if w in ("&", "&&"):
            det_marked = det_marked or w == "&&"
            groups.append([])
        else:
            groups[-1].append(w)
    groups = [g for g in groups if g]
    if not groups:
        return []
    if len(groups) == 1:
        run = groups[0]
        return [(noun_lemma(run[-1]), [_attr_lemma(w) for w in run[:-1]])]
    last = groups[-1]
    if not det_marked and len(last) > 1 and all(len(g) == 1 for g in groups[:-1]):
        # "black and white dog": earlier single-word conjuncts + the last
        # conjunct's modifiers are all attributes of the one head
        attrs = [_attr_lemma(g[0]) for g in groups[:-1]]
        attrs += [_attr_lemma(w) for w in last[:-1]]
        return [(noun_lemma(last[-1]), attrs)]
    # head coordination: each conjunct parses alone
    return [
        (noun_lemma(g[-1]), [_attr_lemma(w) for w in g[:-1]]) for g in groups
    ]


def _attr_lemma(word):
    if word in NUMBER_WORDS:
        return NUMBER_WORDS[word]
    if word.isdigit():
        return word
    if _is_verb(word):
        return _verb_lemma(word)
    return noun_lemma(word)


# ------------------------------------------------------------- scoring


def _canon_tuple(tup):
    return tuple(canonical(x) for x in tup)


# attribute subclasses for the jar's per-category breakdown (SPICE paper
# Table 2: Color / Count / Size are subsets of Attribute)
COLOR_WORDS = frozenset(
    "white black red blue green yellow brown gray grey orange pink purple "
    "golden tan beige maroon navy teal silver".split()
)
SIZE_WORDS = frozenset(
    "big small large little tiny huge tall short long wide giant enormous "
    "massive miniature".split()
)


def _tuple_category(tup) -> str:
    if len(tup) == 1:
        return "Object"
    if len(tup) == 3:
        return "Relation"
    return "Attribute"


def _attr_subclass(tup) -> str | None:
    a = tup[1]
    if a.isdigit():
        return "Count"
    if a in COLOR_WORDS:
        return "Color"
    if a in SIZE_WORDS:
        return "Size"
    return None


def _sets_f1(cand: set, ref: set) -> float:
    if not cand or not ref:
        return 0.0
    inter = len(cand & ref)
    p = inter / len(cand)
    r = inter / len(ref)
    if p + r == 0:
        return 0.0
    return 2 * p * r / (p + r)


def spice_f1(cand_tokens: list, refs_tokens: list) -> float:
    """Per-image SPICE: F1 over the candidate tuple set vs the UNION of the
    reference captions' tuple sets (Anderson et al. §3.1), synonym-canonical
    matching."""
    return spice_scores(cand_tokens, refs_tokens)["All"] or 0.0


def spice_scores(cand_tokens: list, refs_tokens: list) -> dict:
    """Per-image SPICE with the jar's per-category breakdown: ``All`` plus
    F1 restricted to Object / Attribute / Relation tuples and the
    Color / Count / Size attribute subclasses (SPICE paper Table 2; the jar
    emits the same keys per image). Categories are decided by structure —
    tuple arity and attribute word class — identically on both sides.

    A category with NO tuples on the reference side scores ``None`` (the
    jar's NaN): the image carries no signal for that category and must be
    skipped, not counted as 0, when averaging over a corpus."""
    cand = {_canon_tuple(t) for t in parse_tuples(cand_tokens)}
    ref: set = set()
    for r in refs_tokens:
        ref |= {_canon_tuple(t) for t in parse_tuples(r)}

    def score(c, g):
        if not g:
            return None
        return _sets_f1(c, g)

    out = {"All": score(cand, ref)}
    for cat in ("Object", "Attribute", "Relation"):
        out[cat] = score(
            {t for t in cand if _tuple_category(t) == cat},
            {t for t in ref if _tuple_category(t) == cat},
        )
    for sub in ("Color", "Count", "Size"):
        out[sub] = score(
            {t for t in cand if len(t) == 2 and _attr_subclass(t) == sub},
            {t for t in ref if len(t) == 2 and _attr_subclass(t) == sub},
        )
    return out
