"""User-facing inference API: greedy and beam evaluation over dataset splits.

The port's counterpart of the JAX package's ``infer/api.py``
(BasicInference / BeamSearchInference, reference inference.py:18-264): each
batch is encoded once and decoded by ``greedy_decode`` or ``beam_search``,
eagerly. The decode is not replayed from CUDA graphs: the trainer hands this
object new params every epoch, and a graph keyed on the params' pointers
would capture anew each time and grow its pool without bound.

Quirk kept for metric parity: predictions carry the trailing EOS word
('zeros') and the references get EOS appended by ``normalize_captions``
before scoring (inference.py:132-156).
"""

from __future__ import annotations

import torch

from ..data.prefetch import prefetch
from ..runtime import resolve_device
from .beam import beam_search
from .greedy import greedy_decode


class BasicInference:
    """Greedy decoding + test-set evaluation (inference.py:18-130). ``params``
    lie on ``device`` (default ``"cuda"``; it raises without a card)."""

    def __init__(self, captioner, params, dataset_provider, test_dataset_provider=None,
                 metrics=None, max_caption_length: int = 20, *, device="cuda"):
        self.captioner = captioner
        self.params = params
        self.device = resolve_device(device)
        self._provider = dataset_provider
        self._test_provider = test_dataset_provider or dataset_provider
        self._pp = dataset_provider.caption_preprocessor
        self._max_len = max_caption_length
        if metrics is None:
            from ..evalx.metrics import default_metrics

            metrics = default_metrics()
        self._metrics = metrics

    # -- decoding ---------------------------------------------------------

    def _decode(self, feat_grid):
        tokens, _ = greedy_decode(self.captioner, self.params, feat_grid,
                                  self._pp.SOS_TOKEN_LABEL_ENCODED,
                                  self._pp.EOS_TOKEN_LABEL_ENCODED, self._max_len)
        return tokens

    @torch.no_grad()
    def predict_batch(self, images) -> list[str]:
        images = torch.as_tensor(images, dtype=self.params["decoder"]["embedding"].dtype,
                                 device=self.device)
        tokens = self._decode(self.captioner.encode(self.params, images))
        return self._tokens_to_strings(tokens.cpu().numpy())

    def _tokens_to_strings(self, tokens) -> list[str]:
        eos = self._pp.EOS_TOKEN_LABEL_ENCODED
        out = []
        for row in tokens:
            words = []
            for tok in row:
                if tok == 0:
                    break
                words.append(self._pp.word_of[int(tok)])
                if tok == eos:
                    break
            # predictions end with the EOS word (see the module docstring)
            if not words or words[-1] != self._pp.EOS_TOKEN:
                words.append(self._pp.EOS_TOKEN)
            out.append(" ".join(words))
        return out

    # -- evaluation ---------------------------------------------------------

    def _predict_split(self, gen_fn, steps):
        results, data = [], []
        # a producer thread decodes the next batch's images meanwhile
        # (GeneratorEnqueuer, inference.py:63-92)
        gen = prefetch(gen_fn(include_datum=True))
        try:
            for _ in range(steps):
                (cap_in, imgs), y, datum_batch = next(gen)
                results += self.predict_batch(imgs)
                data += list(datum_batch)
        finally:
            gen.stop()   # the producer thread ends when decoding raises too
        return list(zip(results, data))

    def predict_test_set(self):
        return self._predict_split(self._test_provider.test_set, self._test_provider.test_steps)

    def predict_validation_set(self):
        return self._predict_split(self._provider.validation_set, self._provider.validation_steps)

    def evaluate_test_set(self, include_prediction: bool = False):
        return self._evaluate(self.predict_test_set(), include_prediction)

    def evaluate_validation_set(self, include_prediction: bool = False):
        return self._evaluate(self.predict_validation_set(), include_prediction)

    def _evaluate(self, caption_datum_pairs, include_prediction=False):
        """id -> prediction and id -> references, one entry per image id (its
        first datum), scored by every metric (inference.py:132-156)."""
        id_to_prediction, id_to_references = {}, {}
        for caption_pred, datum in caption_datum_pairs:
            img_id = datum.img_filename
            if img_id in id_to_prediction:
                continue
            refs = self._pp.normalize_captions(list(datum.all_captions_txt))
            id_to_references[img_id] = [{"caption": c} for c in refs]
            id_to_prediction[img_id] = [{"caption": caption_pred}]
        metrics = {}
        for metric in self._metrics:
            metrics.update(metric.calculate(id_to_prediction, id_to_references))
        return (metrics, id_to_prediction, id_to_references) if include_prediction else metrics


class BeamSearchInference(BasicInference):
    """Beam-search decoding (inference.py:159-264)."""

    def __init__(self, *args, beam_size: int = 3, **kw):
        super().__init__(*args, **kw)
        self._beam_size = beam_size

    def _decode(self, feat_grid):
        tokens, _ = beam_search(self.captioner, self.params, feat_grid,
                                self._pp.SOS_TOKEN_LABEL_ENCODED,
                                self._pp.EOS_TOKEN_LABEL_ENCODED, self._beam_size, self._max_len)
        return tokens
