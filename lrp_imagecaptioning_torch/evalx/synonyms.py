"""Offline caption-domain synonym table (WordNet-derived, vendored as data).

The port's own copy of the JAX package's ``evalx/synonyms.py`` (pure Python), held to it
by the port's tests.

The reference's METEOR jar matches unaligned word pairs through a WordNet
synonym stage, and its SPICE jar matches scene-graph tuple elements by
WordNet synset overlap (reference models/metrics.py:62-84 shells out to
those jars). No WordNet data ships in this environment, so this module
vendors the relevant slice as data: a curated table of word groups from the
caption domain (COCO / Flickr30k vocabulary), each group the single-word
lemmas of one WordNet synset (plus the standard British/American spelling
pairs, which WordNet lists as lemmas of the same synset).

Curation rules, in order of priority:

1. every group's words share a WordNet synset (the jar's match criterion);
2. a word appears in AT MOST ONE group. WordNet is a graph — polysemous
   words belong to many synsets — but this table matches by canonical
   representative, which is transitive; a word in two groups would merge
   them and create pairs the jar would never match (e.g. "picture" links
   photograph.n.01 and movie.n.01, but the jar does not match
   photo~film). Where WordNet overlaps, the word is kept in its most
   caption-frequent sense and dropped from the rest;
3. lemmas that would create caption-domain false positives through
   polysemy are dropped even when WordNet sanctions them (e.g. "dog" is a
   lemma of the hotdog synset; "morning" of the dawn synset; "coach" of
   the bus synset).

Within those rules the table is deliberately jar-faithful rather than
conservative: polysemous pairs the jar WOULD match (pool~pond,
newspaper~paper, watch~wristwatch) are kept.

Consumers:

* ``evalx.metrics.METEOR`` — the fallback's synonym matcher stage (stage 3
  after exact and stem, NLTK ``meteor_score`` ordering). Measured stage
  contribution: experiments/METEOR_FALLBACK_BOUND.json.
* ``evalx.spice_fallback`` — tuple-element canonicalization before set
  matching (the jar's synset-overlap equivalence). Measured effect:
  experiments/SPICE_PARSER_COVERAGE.json.

``canonical(word)`` maps a word to its group representative (itself when
untabled); ``lookup(word)`` additionally tries light morphology (plural and
verb-inflection stripping) so inflected surface forms hit their base
form's group, mirroring WordNet's morphy normalization in both jars.
"""

from __future__ import annotations

# One group per line; the first word is the canonical representative.
_GROUPS_DATA = """
bike bicycle cycle
motorcycle motorbike
car auto automobile motorcar
taxi cab taxicab
truck lorry
airplane aeroplane plane
bus autobus omnibus
tram streetcar trolley
subway metro
van minivan
helicopter chopper
elevator lift
windshield windscreen
gas gasoline petrol
sidewalk pavement
road route
freeway motorway expressway
alley alleyway
wharf dock pier
lighthouse beacon
bridge span
plaza piazza
harbor harbour
theater theatre
center centre
meter metre
liter litre
fiber fibre
color colour
gray grey
favorite favourite
neighbor neighbour
armor armour
humor humour
flavor flavour
honor honour
labor labour
rumor rumour
odor odour
parlor parlour
splendor splendour
vapor vapour
plow plough
ax axe
tire tyre
curb kerb
donut doughnut
mustache moustache
pajamas pyjamas
jewelry jewellery
traveler traveller
jeweler jeweller
aluminum aluminium
catalog catalogue
dialog dialogue
program programme
whiskey whisky
yogurt yoghurt
omelet omelette
draft draught
defense defence
offense offence
license licence
story storey
marvelous marvellous
woolen woollen
skillful skilful
analyze analyse
organize organise
realize realise
recognize recognise
apologize apologise
photo photograph pic picture
movie film flick
sofa couch
tv television telly
fridge refrigerator icebox
faucet spigot
trash rubbish
curtain drape drapery
carpet rug carpeting
cupboard closet
quilt comforter duvet
bathtub tub
toilet commode
cellphone mobile
phone telephone
flashlight torch
handbag purse pocketbook
backpack knapsack rucksack
luggage baggage
glasses spectacles eyeglasses specs
watch wristwatch
trousers pants
sweater jumper
vest waistcoat
swimsuit swimwear
dress frock
clothes apparel
necktie tie
apartment flat
shop store
cafe coffeehouse
restaurant eatery
bar barroom saloon
market marketplace mart
kid child youngster tyke
baby infant babe
person individual someone somebody
couple pair duo twosome
bunch crowd crew gang
mother mom mum mommy momma mama
father dad daddy papa pop
grandmother grandma granny
grandfather grandpa granddad grandad
policeman officer
doctor physician doc
lawyer attorney
teacher instructor
student pupil
friend pal buddy chum
waiter server
shopkeeper storekeeper tradesman
pilot aviator
singer vocalist
musician instrumentalist
actor thespian
clown buffoon
magician conjurer illusionist
spectator viewer watcher
athlete jock
stomach belly tummy abdomen
puppy pup
kitten kitty
pig hog
seagull gull
ladybug ladybird
hotdog frankfurter wiener
hamburger burger beefburger
cookie biscuit
eggplant aubergine
zucchini courgette
cilantro coriander
corn maize
shrimp prawn
soda pop
ketchup catsup
liquor booze
meal repast
beverage drink
lunch luncheon
vegetable veggie
candy confect
rock stone
dirt soil
flower bloom blossom
leaf foliage
branch limb
bush shrub
forest woods
orchard grove
valley vale
brook creek
coast seashore seacoast
waterfall falls
pond pool
storm tempest
sunset sundown
sunrise sunup dawn daybreak
mountain mount
toy plaything
doll dolly
gift present
can tin
bucket pail
barrel cask
poster placard
banner streamer
newspaper paper
tune melody
violin fiddle
trumpet cornet
wallet billfold
staircase stairway
building edifice
monument memorial
airport aerodrome
gym gymnasium
stadium arena
racket racquet
sled sledge sleigh
contest competition
team squad
wrench spanner
hose hosepipe
radio wireless
loudspeaker speaker
headphone earphone
napkin serviette
diaper nappy
crib cot
stroller pram pushchair perambulator
carousel merry-go-round
sandbox sandpit
vacation holiday
wedding marriage
job task chore
hospital infirmary
big large
small little
huge immense vast
enormous tremendous
gigantic mammoth
tiny petite
quick rapid speedy
aged elderly
young youthful
wide broad
round circular
hard difficult
dirty soiled unclean
damp moist
bright brilliant vivid
shiny glossy lustrous
colorful colourful
lovely adorable endearing
funny amusing comical
frightened scared
silent soundless
slim slender svelte
begin start commence
end finish terminate cease
stop halt
depart exit
stroll saunter
jog trot
jump leap
crawl creep
dive plunge
spin whirl twirl
lean tilt
speak talk
say state
shout yell scream holler
chat chatter natter
cry weep
gaze stare
glance peek
point indicate
hug embrace
cuddle snuggle nestle
clap applaud
gather assemble
choose select
buy purchase
carry transport
lift raise elevate
hit strike
close shut
repair mend
build construct
cook prepare
sleep slumber
doze snooze drowse
fight struggle
teach instruct
display exhibit
hide conceal
help assist aid
relax unwind
stay remain
travel journey
wander roam ramble rove
hurry rush hasten
wash launder
write compose
put place
sniff whiff
chew masticate
hop skip
toss flip
tumble topple
slide skid slip
splash sprinkle
soak drench douse
spill splatter
swing sway
rotate revolve
bounce rebound ricochet
glow shine radiate
sparkle glitter glisten gleam
flutter flicker quiver
drip trickle
dig excavate
harvest reap
stack pile heap
decorate adorn ornament embellish
marry wed
camp encamp
sail navigate voyage
calm serene tranquil
wealthy affluent
cheap inexpensive
costly pricey
joyful joyous
foggy hazy misty
rainy showery
windy breezy
muddy marshy swampy
rocky stony
fluffy downy
striped stripy streaked
speckled flecked dotted
checkered checked chequered
blond blonde
ferry ferryboat
dinghy rowboat
snake serpent
alligator gator
crocodile croc
hippopotamus hippo
rhinoceros rhino
chimpanzee chimp
raccoon racoon
possum opossum
groundhog woodchuck
skillet frypan
counter countertop
attic garret
basement cellar
patio terrace
fireplace hearth
blackboard chalkboard
brochure pamphlet booklet leaflet
microphone mike
cello violoncello
saxophone sax
mailbox postbox
hydrant fireplug
billboard hoarding
awning sunshade
ramp incline
braid plait
forehead brow
pancake flapjack hotcake griddlecake
potato spud
cucumber cuke
practice practise
goalkeeper goalie goaltender
referee ref
umpire ump
captain skipper
champion champ
opponent adversary
medal medallion
crown diadem
fort fortress
cemetery graveyard necropolis
gravestone headstone tombstone
coffin casket
grave tomb
recliner lounger
dresser bureau
dryer drier
doorbell buzzer
icing frosting
appetizer appetiser
feast banquet
picnic outing
barbecue barbeque cookout
deserted abandoned derelict
lush luxuriant
oval elliptical
golden gilded gilt
clumsy awkward
agile nimble spry
sturdy rugged
fragile delicate frail
slippery slippy
chubby plump pudgy tubby
skinny scrawny
muscular brawny
giant gargantuan jumbo
blizzard snowstorm
tornado twister
peak summit
swamp marsh marshland swampland
riverbank riverside
fireman firefighter
mailman postman
hairdresser hairstylist stylist
vet veterinarian
professor prof
astronaut spaceman cosmonaut
bartender barman barkeep
cashier teller
reporter newsman
writer author
swimmer bather
cyclist bicyclist
wrestler grappler
fisherman fisher
hunter huntsman
shepherd sheepherder
cowboy cowhand cowpoke
vendor seller
customer client
pirate buccaneer
ghost specter spectre
chuckle chortle
giggle titter
melt thaw
scrub scour
sew stitch
bathe bath
"""


def _build_groups():
    groups = []
    seen = {}
    for line in _GROUPS_DATA.strip().splitlines():
        words = tuple(line.split())
        if len(words) < 2:
            continue
        merged = None
        for w in words:
            if w in seen:
                merged = seen[w]
                break
        if merged is not None:
            # overlap safeguard: the curation rule says this must not happen;
            # merging keeps the table well-formed if an edit violates it
            idx = merged
            groups[idx] = tuple(dict.fromkeys(groups[idx] + words))
        else:
            idx = len(groups)
            groups.append(words)
        for w in groups[idx]:
            seen[w] = idx
    return groups, {w: groups[i][0] for w, i in seen.items()}


SYNSET_GROUPS, _CANON = _build_groups()


def n_groups() -> int:
    return len(SYNSET_GROUPS)


def canonical(word: str) -> str:
    """Group representative of ``word`` (itself when untabled)."""
    return _CANON.get(word, word)


_VOWELS = set("aeiou")


def _morph_candidates(word: str):
    """Light morphology: base-form candidates for an inflected surface form
    (mirrors WordNet morphy's detachment rules for -s/-es/-ies/-ed/-ing)."""
    if word.endswith("ies") and len(word) > 4:
        yield word[:-3] + "y"
    if word.endswith("es") and len(word) > 3:
        yield word[:-2]
    if word.endswith("s") and not word.endswith("ss") and len(word) > 3:
        yield word[:-1]
    for suf in ("ed", "ing"):
        if word.endswith(suf) and len(word) > len(suf) + 2:
            stem = word[: -len(suf)]
            yield stem
            yield stem + "e"  # raced -> race, racing -> race
            if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
                yield stem[:-1]  # jogged -> jog
    if word.endswith("ied") and len(word) > 4:
        yield word[:-3] + "y"


def lookup(word: str) -> str:
    """``canonical`` with morphology fallback: an inflected form canonicalizes
    through its base form's group ("bikes" -> bike-group, "hurried" ->
    hurry-group), the way the jars' morphy-normalized WordNet lookups do."""
    hit = _CANON.get(word)
    if hit is not None:
        return hit
    for cand in _morph_candidates(word):
        hit = _CANON.get(cand)
        if hit is not None:
            return hit
    return word


def are_synonyms(a: str, b: str) -> bool:
    """True when the two surface forms canonicalize into one group."""
    ca, cb = lookup(a), lookup(b)
    return ca == cb and (ca != a or cb != b or a == b or _CANON.get(a) is not None)
