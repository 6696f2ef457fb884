"""Pretrained word-vector embedding initializers.

The port of the JAX package's ``models/word_vectors.py`` (reference
models/word_vectors.py:6-86, WordVector / Glove / Fasttext): the embedding
table takes a pretrained vector file's row for every vocabulary word the
file has; the other rows keep a Glorot-uniform draw, the reference's
fallback to the Keras initializer. The draw comes from a ``torch.Generator``:
the same law as the JAX package's, not ``jax.random``'s bits.

File format: the GloVe/fastText text format ``word v1 v2 ... vd`` (fastText
files may carry a ``count dim`` header line, which is skipped)."""

from __future__ import annotations

import math

import numpy as np
import torch


def glorot_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out)), on the CPU."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen) * 2 - 1) * limit


class WordVector:
    def __init__(self, vocab_words: list[str], initializer, path: str, embedding_dim: int):
        """vocab_words[i] is the word for 1-based token id i+1 == 0-based
        model row i (the reference builds the matrix in model-id order,
        word_vectors.py:44-63). ``initializer(generator, shape)`` draws the
        rows the file does not cover."""
        self._vocab = vocab_words
        self._initializer = initializer
        self._path = path
        self._dim = embedding_dim

    def vectorize_words(self, generator: torch.Generator | None = None) -> torch.Tensor:
        """The (V, E) table, f32 on the CPU; ``generator`` (a torch.Generator,
        where the JAX package takes a PRNG key) draws the uncovered rows."""
        if generator is not None and not isinstance(generator, torch.Generator):
            raise TypeError(f"generator must be a torch.Generator, got {type(generator).__name__}")
        vectors = self._load_vectors()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        table = self._initializer(generator, (len(self._vocab), self._dim)).clone()
        for i, word in enumerate(self._vocab):
            v = vectors.get(word)
            if v is not None:
                table[i] = torch.from_numpy(v)
        return table

    def _load_vectors(self) -> dict:
        if self._path is None:
            raise ValueError("pretrained word vectors need a vector file (word_vector_path)")
        vectors = {}
        vocab = set(self._vocab)
        with open(self._path, "r", encoding="utf-8", errors="ignore") as f:
            parts = f.readline().rstrip().split(" ")
            if len(parts) != 2:  # not a fastText header: a data line
                self._maybe_add(vectors, vocab, parts)
            for line in f:
                self._maybe_add(vectors, vocab, line.rstrip().split(" "))
        return vectors

    def _maybe_add(self, vectors, vocab, parts):
        if len(parts) == self._dim + 1 and parts[0] in vocab:
            vectors[parts[0]] = np.asarray(parts[1:], dtype=np.float32)


class Glove(WordVector):
    """glove.6B-style text files (word_vectors.py:66-74)."""


class Fasttext(WordVector):
    """wiki-news-300d-style .vec files (word_vectors.py:77-86)."""


def init_embedding(generator: torch.Generator, vocab_words: list[str], embedding_dim: int,
                   pretrained: str | None = None, path: str | None = None) -> torch.Tensor:
    """The (V, E) embedding table, optionally seeded from glove/fasttext
    (model.py:80-93, _build_word_embedding), f32 on the CPU."""
    if pretrained is None:
        return glorot_uniform(generator, (len(vocab_words), embedding_dim))
    cls = {"glove": Glove, "fasttext": Fasttext}[pretrained]
    return cls(vocab_words, glorot_uniform, path, embedding_dim).vectorize_words(generator)
