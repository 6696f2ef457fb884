"""Batch provider: vocabulary building + infinite batch generators.

The port's own copy of the JAX package's ``data/provider.py`` (numpy only):
its batches equal the JAX package's byte for byte. Equivalent of
DatasetPreprocessorAttention (preparedataset.py:478-581): builds the
vocabulary from the training captions (every reference when
``single_caption=True``, else one caption per datum), then yields
``([captions_input, imgs_input], captions_onehot_output)`` batches.

Beyond the reference: ``pad_to_length`` pads every batch to one static T
(the reference pads to each batch's longest caption); ``drop_remainder``
drops the short batch at an epoch's end; ``skip_batches`` fast-forwards
without preprocessing the skipped batches (resume).
"""

from __future__ import annotations

import math
from itertools import chain

import numpy as np

from .images import ImagePreprocessor
from .tokenizer import CaptionPreprocessor


class DatasetProvider:
    def __init__(self, dataset, config, single_caption: bool = False):
        self.config = config
        self.batch_size = config.batch_size
        self.dataset = dataset
        self.single_caption = single_caption
        self.image_preprocessor = ImagePreprocessor(
            config.img_encoder, config.image_augmentation,
            image_size=getattr(config, "image_size", None),
        )
        self.caption_preprocessor = CaptionPreprocessor(
            config.rare_words_handling, config.words_min_occur
        )
        self.build_vocabulary()

    # -- vocab ----------------------------------------------------------

    @property
    def vocabs(self):
        return self.caption_preprocessor.vocabs

    @property
    def vocab_size(self):
        return self.caption_preprocessor.vocab_size

    def build_vocabulary(self):
        training_set = self.dataset.training_set
        if self.single_caption:
            captions = list(chain.from_iterable(d.all_captions_txt for d in training_set))
        else:
            captions = [d.caption_txt for d in training_set]
        self.caption_preprocessor.fit_on_captions(captions)

    # -- steps ------------------------------------------------------------

    @property
    def training_steps(self):
        return int(math.ceil(self.dataset.training_set_size / self.batch_size))

    @property
    def validation_steps(self):
        return int(math.ceil(self.dataset.validation_set_size / self.batch_size))

    @property
    def test_steps(self):
        return int(math.ceil(self.dataset.test_set_size / self.batch_size))

    @property
    def training_results_dir(self):
        return self.dataset.training_results_dir

    # -- generators -------------------------------------------------------

    def training_set(self, include_datum=False, pad_to_length=None,
                     skip_batches=0, drop_remainder=False):
        yield from self._batch_generator(
            self.dataset.training_set, include_datum, random_transform=True,
            pad_to_length=pad_to_length, skip_batches=skip_batches,
            drop_remainder=drop_remainder,
        )

    def validation_set(self, include_datum=False, pad_to_length=None):
        yield from self._batch_generator(
            self.dataset.validation_set, include_datum, random_transform=False, pad_to_length=pad_to_length
        )

    def test_set(self, include_datum=False, pad_to_length=None):
        yield from self._batch_generator(
            self.dataset.test_set, include_datum, random_transform=False, pad_to_length=pad_to_length
        )

    def _batch_generator(self, datum_list, include_datum, random_transform,
                         pad_to_length=None, skip_batches=0, drop_remainder=False):
        """``skip_batches``: fast-forward past the first N batches WITHOUT
        preprocessing them (resume support — pulling skipped batches through
        image decode/resize only to discard them costs hours at scale).
        ``drop_remainder``: skip the short epoch-tail batch so every yield
        has the static batch size (jit / mesh-divisibility requirement)."""
        datum_list = list(datum_list)
        to_skip = int(skip_batches)

        def emit(batch):
            nonlocal to_skip
            if to_skip > 0:
                to_skip -= 1
                return None
            return self._preprocess_batch(batch, include_datum, random_transform, pad_to_length)

        while True:
            batch = []
            for datum in datum_list:
                batch.append(datum)
                if len(batch) >= self.batch_size:
                    out = emit(batch)
                    if out is not None:
                        yield out
                    batch = []
            if batch and not drop_remainder:
                out = emit(batch)
                if out is not None:
                    yield out

    def _preprocess_batch(self, datum_batch, include_datum, random_transform, pad_to_length=None):
        imgs_input = self.image_preprocessor.preprocess_batch_paths(
            [d.img_path for d in datum_batch], random_transform
        )
        caption_batch = self.caption_preprocessor.encode_captions([d.caption_txt for d in datum_batch])
        captions_input, captions_output = self.caption_preprocessor.preprocess_batch(
            caption_batch, maxlen=pad_to_length
        )
        X, y = [captions_input, imgs_input], captions_output
        return (X, y, datum_batch) if include_datum else (X, y)
