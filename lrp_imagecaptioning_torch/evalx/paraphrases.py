"""Offline caption-domain paraphrase table (vendored as data).

The port's own copy of the JAX package's ``evalx/paraphrases.py`` (pure Python), held to it
by the port's tests.

The reference's METEOR jar has a fourth matcher stage that aligns multi-word
PHRASE pairs from ``paraphrase-en.gz`` (reference models/metrics.py:62-73
requires that file next to meteor-1.5.jar before it will run the jar at
all). That table is ~50 MB of pivot-method pairs and has no offline source
in this environment, so this module vendors the caption-domain slice as
data: curated groups of interchangeable phrases from COCO / Flickr30k
caption vocabulary, where at least one member of each group is multi-word
(single-word~single-word pairs belong in ``evalx.synonyms``; the METEOR
stage ladder consults that table first, so duplicating them here would
never fire).

Curation rules, in order of priority:

1. every group's phrases are substitutable in caption context with the
   same meaning (the pivot table's criterion, restricted to pairs a human
   caption-writer actually produces);
2. a phrase appears in AT MOST ONE group — the table matches by canonical
   representative, which is transitive, so an overlap would merge groups;
3. phrases made entirely of high-frequency function words ("on", "with",
   "to") are excluded even when the pivot table would sanction them: at
   caption length ~10 they match promiscuously and move scores the jar's
   weighted-stage formula would damp but our classic formula would not.

Groups fall into three families, mirroring what the real table contributes
on caption text: compound spelling variants ("hot dog" ~ "hotdog"),
named-object variants ("traffic light" ~ "stoplight"), and
preposition/quantifier phrases ("next to" ~ "beside").

Consumers:

* ``evalx.metrics.METEOR`` — the fallback's paraphrase matcher stage
  (stage 4 after exact, stem, and synonym — METEOR 1.5's stage order).
  Measured stage contribution: experiments/METEOR_FALLBACK_BOUND.json.

``lookup_phrase(words)`` maps a tuple of surface words to its group
representative (None when untabled); ``are_paraphrases(a, b)`` tests two
phrases for membership in one group. Matching is surface-form, like the
jar's table lookup — inflection variants worth matching are listed
explicitly as members.
"""

from __future__ import annotations

# One group per line; phrases separated by " | "; the first phrase is the
# canonical representative.
_GROUPS_DATA = """
next to | beside | alongside | next to each other | side by side
in front of | ahead of
in back of | behind
close to | near | not far from
far from | far away from | a long way from
in the middle of | in the center of | in the centre of
on top of | atop
a lot of | lots of | plenty of | a large number of
a couple of | a pair of
a few | a handful of | a small number of
a group of | a bunch of | a cluster of
a crowd of | a throng of
each other | one another
kind of | sort of
getting ready to | preparing to | about to
trying to | attempting to
taking a picture | taking a photo | taking pictures | taking photos | photographing
taking a nap | napping | sleeping
riding a bike | riding a bicycle | cycling | bicycling | biking
riding a horse | on horseback | horseback riding
talking on the phone | on the phone | making a phone call
sitting down | seated | sitting
standing up | standing
looking at | watching | gazing at | staring at
jumping over | leaping over | jumping across
walking down | walking along
getting off | dismounting | getting off of
getting on | boarding | getting onto
because of | due to
in spite of | despite
police officer | policeman | police man | cop
fire truck | fire engine | firetruck
fire hydrant | hydrant
hot dog | hotdog | frankfurter
cell phone | cellphone | mobile phone | mobile
t-shirt | t shirt | tee shirt | tshirt
living room | sitting room | lounge room
dining room | dining area
bathing suit | swimsuit | swim suit | swimming costume
teddy bear | stuffed bear
stuffed animal | plush toy | stuffed toy
remote control | remote
traffic light | traffic signal | stoplight | stop light
parking lot | car park | parking area
trash can | garbage can | trash bin | garbage bin | rubbish bin | wastebasket | waste basket
french fries | fries
ice cream | icecream | ice-cream
skateboard | skate board
snowboard | snow board
surfboard | surf board
wine glass | wineglass | wine-glass
hair dryer | hairdryer | blow dryer
merry-go-round | merry go round | carousel
christmas tree | xmas tree
train station | railway station | railroad station | train depot
bus stop | bus station
soccer field | football pitch | soccer pitch | football field
baseball field | baseball diamond | ball field
tennis court | tennis courts
hot air balloon | hot-air balloon
double decker bus | double-decker bus | double decker
semi truck | semi-truck | tractor trailer | tractor-trailer | semi
pickup truck | pick up truck | pick-up truck | pickup
motor bike | motorbike | motor cycle
street light | streetlight | street lamp | lamp post | lamppost
palm tree | palm
city street | urban street
dirt road | dirt path | dirt track
body of water | water body
young man | young guy
young woman | young lady
little boy | small boy
little girl | small girl
old man | elderly man
old woman | elderly woman
"""


def _build_groups():
    groups = []
    seen = {}
    for line in _GROUPS_DATA.strip().splitlines():
        phrases = tuple(
            tuple(p.split()) for p in (s.strip() for s in line.split("|")) if p
        )
        if len(phrases) < 2:
            continue
        merged = None
        for p in phrases:
            if p in seen:
                merged = seen[p]
                break
        if merged is not None:
            # overlap safeguard: curation rule 2 says this must not happen;
            # merging keeps the table well-formed if an edit violates it
            idx = merged
            groups[idx] = tuple(dict.fromkeys(groups[idx] + phrases))
        else:
            idx = len(groups)
            groups.append(phrases)
        for p in groups[idx]:
            seen[p] = idx
    canon = {p: groups[i][0] for p, i in seen.items()}
    max_len = max(len(p) for p in seen)
    return groups, canon, max_len


PHRASE_GROUPS, _CANON, MAX_PHRASE_LEN = _build_groups()


def n_groups() -> int:
    return len(PHRASE_GROUPS)


def lookup_phrase(words) -> tuple | None:
    """Group representative of the phrase ``words`` (a sequence of surface
    tokens), or None when the phrase is not in the table."""
    return _CANON.get(tuple(words))


def are_paraphrases(a, b) -> bool:
    """True when the two phrases (token sequences) sit in one group."""
    ca, cb = _CANON.get(tuple(a)), _CANON.get(tuple(b))
    return ca is not None and ca == cb
