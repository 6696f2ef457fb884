"""Caption tokenization with exact Keras-2.2.4-Tokenizer-compatible semantics.

The port's own copy of the JAX package's ``data/tokenizer.py`` (numpy only),
held to it by tests/test_torch_data.py.

The whole reference codebase leans on a 1-based tokenizer id space and a
0-based model label space (the "parity landmine": reference
models/preprocessors.py:166-189 shifts the one-hot targets by one column;
inference.py:219 converts model->tokenizer with ``word+1``; explainers.py:403
embeds ``SOS-1``). This module reproduces those semantics bit-for-bit:

* word index built sorted by count desc with stable insertion order for ties
  (Keras ``Tokenizer.fit_on_texts``), ids starting at 1;
* SOS token 'szeros', EOS token 'zeros' (preprocessors.py:59-60);
* rare-word *discard* below ``words_min_occur`` happens on the raw corpus
  BEFORE SOS/EOS are appended (preprocessors.py:191-206);
* ``preprocess_batch`` pads post, shifts targets one timestep, one-hots and
  drops column 0 so labels are 0-based while tokenizer ids stay 1-based.
"""

from __future__ import annotations

import numpy as np

_KERAS_FILTERS = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n'


def text_to_word_sequence(text: str, filters: str = _KERAS_FILTERS, lower: bool = True, split: str = " "):
    """Keras's text_to_word_sequence: lower, strip filter chars, split."""
    if lower:
        text = text.lower()
    translate_map = {ord(c): split for c in filters}
    text = text.translate(translate_map)
    return [w for w in text.split(split) if w]


class KerasCompatTokenizer:
    """Reimplementation of keras.preprocessing.text.Tokenizer (defaults only).

    Ids are 1-based; id order is by descending corpus count with stable
    insertion order breaking ties (Python sort stability matches Keras
    2.2.4's ``sorted(word_counts.items(), key=..., reverse=True)``).
    """

    def __init__(self):
        self.word_counts: dict[str, int] = {}
        self.word_index: dict[str, int] = {}

    def fit_on_texts(self, texts):
        for text in texts:
            for w in text_to_word_sequence(text):
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
        wcounts = sorted(self.word_counts.items(), key=lambda x: x[1], reverse=True)
        self.word_index = {w: i + 1 for i, (w, _) in enumerate(wcounts)}

    def texts_to_sequences(self, texts):
        out = []
        for text in texts:
            seq = []
            for w in text_to_word_sequence(text):
                i = self.word_index.get(w)
                if i is not None:
                    seq.append(i)
            out.append(seq)
        return out


class CaptionPreprocessor:
    """Drop-in equivalent of CaptionPreprocessorAttention (preprocessors.py:57-222)."""

    EOS_TOKEN = "zeros"
    SOS_TOKEN = "szeros"

    def __init__(self, rare_words_handling: str = "discard", words_min_occur: int = 3):
        self._tokenizer = KerasCompatTokenizer()
        self._rare_words_handling = rare_words_handling
        self._words_min_occur = words_min_occur
        self._word_of: dict[int, str] = {}

    # -- vocabulary -----------------------------------------------------

    @property
    def SOS_TOKEN_LABEL_ENCODED(self) -> int:
        return self._tokenizer.word_index[self.SOS_TOKEN]

    @property
    def EOS_TOKEN_LABEL_ENCODED(self) -> int:
        return self._tokenizer.word_index[self.EOS_TOKEN]

    @property
    def vocabs(self):
        wi = self._tokenizer.word_index
        return sorted(wi, key=wi.get)

    @property
    def vocab_size(self) -> int:
        return len(self._word_of)

    @property
    def word_of(self) -> dict[int, str]:
        """tokenizer-id (1-based) -> word"""
        return self._word_of

    def fit_on_captions(self, captions_txt):
        captions_txt = self._handle_rare_words(captions_txt)
        captions_txt = self._add_eos(captions_txt)
        captions_txt = self._add_sos(captions_txt)
        self._tokenizer.fit_on_texts(captions_txt)
        self._word_of = {i: w for w, i in self._tokenizer.word_index.items()}

    # -- encode / decode --------------------------------------------------

    def encode_captions(self, captions_txt):
        """caption text -> 1-based token id lists, SOS/EOS added (preprocessors.py:101-104)."""
        captions_txt = self._add_sos(captions_txt)
        captions_txt = self._add_eos(captions_txt)
        return self._tokenizer.texts_to_sequences(captions_txt)

    def decode_captions_from_list1d(self, caption_encoded):
        """1-based encoded caption -> [joined string] (preprocessors.py:152-160)."""
        return [" ".join(self._word_of[w] for w in caption_encoded)]

    def decode_captions_from_list2d(self, captions_encoded):
        return [" ".join(self._word_of[w] for w in cap) for cap in captions_encoded]

    def normalize_captions(self, captions_txt):
        return self._add_eos(captions_txt)

    # -- batching --------------------------------------------------------

    def preprocess_batch(self, captions_label_encoded, maxlen: int | None = None):
        """1-based id lists -> (captions_input 0-based ids, one-hot targets).

        Mirrors preprocessors.py:166-189: post-pad, shift target by one
        timestep, one-hot at vocab_size+1 then drop column 0; decrement
        nonzero input ids by one so they index the 0-based embedding table.

        Args:
          maxlen: pad/truncate input width (defaults to longest caption, as in
            Keras pad_sequences with padding='post').
        Returns:
          captions_input: (B, T) int32, 0-based ids (padding stays 0 — note a
            real token 1 ('zeros'=EOS is usually id<=2) also maps to 0 after
            the shift only if it was padding; nonzero ids are decremented).
          captions_output: (B, T, vocab_size) int one-hot, all-zero rows for
            padding (so CE there is zero).
        """
        n = len(captions_label_encoded)
        width = maxlen or max((len(c) for c in captions_label_encoded), default=1)
        captions_input = np.zeros((n, width), dtype=np.int32)
        for i, cap in enumerate(captions_label_encoded):
            cap = list(cap)[:width]
            captions_input[i, : len(cap)] = cap

        # target = input shifted left one step, re-padded to the same width
        vocab = len(self._word_of)
        captions_output = np.zeros((n, width, vocab), dtype=np.int32)
        shifted = np.zeros_like(captions_input)
        shifted[:, :-1] = captions_input[:, 1:]
        rows, cols = np.nonzero(shifted)
        captions_output[rows, cols, shifted[rows, cols] - 1] = 1  # drop col 0 == shift -1

        captions_decreased = captions_input.copy()
        captions_decreased[captions_decreased > 0] -= 1
        return captions_decreased, captions_output

    # -- internals ---------------------------------------------------------

    def _handle_rare_words(self, captions):
        if self._rare_words_handling == "nothing":
            return list(captions)
        if self._rare_words_handling == "discard":
            tok = KerasCompatTokenizer()
            tok.fit_on_texts(captions)
            out = []
            for caption in captions:
                words = text_to_word_sequence(caption)
                out.append(" ".join(w for w in words if tok.word_counts.get(w, 0) >= self._words_min_occur))
            return out
        raise NotImplementedError(f"rare_words_handling={self._rare_words_handling}")

    def _add_eos(self, captions):
        return [c + " " + self.EOS_TOKEN for c in captions]

    def _add_sos(self, captions):
        return [self.SOS_TOKEN + " " + c for c in captions]
