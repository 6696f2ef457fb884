"""Region-perturbation analysis (MoRF curves), host-side numpy.

The port's own copy of the JAX package's ``explain/perturbation.py``, itself
the vendored ``innvestigate/tools/perturbate.py``: occlude the
most-relevant image regions according to an explanation and measure how the
model score degrades. The reference walks every region with a Python
``np.ndindex`` loop (perturbate.py:135-148); here the mask is built and
applied over all regions at once. ``analyze_fn`` and ``score_fn`` are
callables over numpy arrays: a caller on the card moves its images there
and its maps back inside them.

Semantics preserved from the reference:

* analysis is channel-reduced with ``reduce_function`` (mean) then padded
  (reflect) to a multiple of ``region_shape`` and aggregated per region with
  ``aggregation_function`` (mean) (perturbate.py:108-128, 163-170).
* region ranks: 0 = highest aggregated relevance (``compute_region_ordering``
  perturbate.py:79-84); the perturbation mask selects
  ``ranks <= num_perturbed_regions - 1`` (perturbate.py:74-77).
* perturbation functions: ``zeros`` | ``gaussian`` (N(0, 0.3)) | ``mean``
  (region mean) | ``invert`` (−x) (perturbate.py:45-57); optional
  ``value_range`` clipping.
* ``PerturbationAnalysis.compute_perturbation_analysis`` returns
  ``steps + 1`` scores: the unperturbed score first, then one score per step
  with ``num_perturbed_regions = 1, 1+regions_per_step, …``
  (perturbate.py:374-397).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class Perturbation:
    """Perturb the highest-ranked regions of a batch of images.

    Arrays are NHWC (this framework's native layout; the reference converts
    channels_last → channels_first internally, perturbate.py:158-161).
    """

    def __init__(self, perturbation_function, num_perturbed_regions: int = 0,
                 region_shape: Sequence[int] = (9, 9), reduce_function=np.mean,
                 aggregation_function=np.mean, pad_mode: str = "reflect",
                 value_range=None, rng: np.random.Generator | None = None):
        self._rng = rng or np.random.default_rng(0)
        self._builtin_mode = None
        if isinstance(perturbation_function, str):
            # builtin modes (zeros/gaussian/mean/invert, perturbate.py:45-57)
            # run through the vectorized branch of perturbate_on_batch;
            # only custom callables are applied per region
            if perturbation_function not in ("zeros", "gaussian", "mean", "invert"):
                raise ValueError(
                    f"Perturbation function type {perturbation_function!r} not known.")
            self._builtin_mode = perturbation_function
            self.perturbation_function = None
        elif callable(perturbation_function):
            self.perturbation_function = perturbation_function
        else:
            raise TypeError(type(perturbation_function))
        self.num_perturbed_regions = num_perturbed_regions
        self.region_shape = tuple(region_shape)
        self.reduce_function = reduce_function
        self.aggregation_function = aggregation_function
        self.pad_mode = pad_mode
        self.value_range = value_range

    # --- reference statics (perturbate.py:74-84) ---
    @staticmethod
    def compute_perturbation_mask(ranks, num_perturbed_regions):
        return ranks <= num_perturbed_regions - 1

    @staticmethod
    def compute_region_ordering(aggregated_regions):
        flat = aggregated_regions.reshape(aggregated_regions.shape[:2] + (-1,))
        order = np.argsort(-flat, axis=-1)
        ranks = order.argsort(axis=-1).reshape(aggregated_regions.shape)
        return ranks

    def _pad(self, arr):
        rh, rw = self.region_shape
        H, W = arr.shape[1], arr.shape[2]
        ph, pw = (-H) % rh, (-W) % rw
        before = (ph // 2, pw // 2)
        pads = ((0, 0), (before[0], ph - before[0]), (before[1], pw - before[1]), (0, 0))
        return np.pad(arr, pads, self.pad_mode), before

    def _to_regions(self, arr):
        rh, rw = self.region_shape
        n, H, W, c = arr.shape
        return arr.reshape(n, H // rh, rh, W // rw, rw, c)

    def aggregate_regions(self, analysis):
        regions = self._to_regions(analysis)
        # (n, hr, wr, c) then move channel in front to match the reference's
        # (n, c, hr, wr) rank layout
        agg = self.aggregation_function(regions, axis=(2, 4))
        return np.moveaxis(agg, -1, 1)

    def perturbate_on_batch(self, x, analysis):
        """x: (n, H, W, C); analysis: (n, H, W, C). Returns perturbed copy."""
        x = np.array(x, dtype=np.float32, copy=True)
        analysis = np.asarray(analysis)
        assert analysis.shape == x.shape, analysis.shape
        H, W = x.shape[1], x.shape[2]

        red = self.reduce_function(analysis, axis=-1, keepdims=True)  # (n,H,W,1)
        red_p, _ = self._pad(red)
        x_p, (ph0, pw0) = self._pad(x)

        agg = self.aggregate_regions(red_p)                 # (n, 1, hr, wr)
        ranks = self.compute_region_ordering(agg)
        mask_regions = self.compute_perturbation_mask(
            ranks, self.num_perturbed_regions)              # (n, 1, hr, wr)

        xr = self._to_regions(x_p)                          # (n,hr,rh,wr,rw,C)
        # Region-selection mask broadcast to pixel granularity:
        # mask_regions (n,1,hr,wr) -> (n,hr,1,wr,1,1)
        sel = mask_regions[:, 0][:, :, None, :, None, None]
        if self._builtin_mode is not None:
            # Vectorized: compute the perturbed value for EVERY region at
            # once, select with the mask (equivalent to the reference's
            # per-region loop for these functions).
            if self._builtin_mode == "zeros":
                pert = np.zeros_like(xr)
            elif self._builtin_mode == "invert":
                pert = -xr
            elif self._builtin_mode == "gaussian":
                pert = self._rng.normal(0.0, 0.3, size=xr.shape)
            else:  # mean: one scalar per region over (rh, rw, C)
                pert = np.broadcast_to(
                    xr.mean(axis=(2, 4, 5), keepdims=True), xr.shape)
            xr = np.where(sel, pert, xr)
        else:
            hrn, wrn = xr.shape[1], xr.shape[3]
            for si in range(xr.shape[0]):                   # custom fn sees
                for ri in range(hrn):                       # one region at a
                    for ci in range(wrn):                   # time, like the
                        if sel[si, ri, 0, ci, 0, 0]:        # reference
                            region = xr[si, ri, :, ci, :, :]
                            xr[si, ri, :, ci, :, :] = self.perturbation_function(region)
        if self.value_range is not None:
            xr = np.clip(xr, self.value_range[0], self.value_range[1])
        x_out = xr.reshape(x_p.shape)[:, ph0:ph0 + H, pw0:pw0 + W, :]
        return x_out.astype(np.float32)


class PerturbationAnalysis:
    """Progressive-perturbation evaluation (perturbate.py:193-397).

    :param analyze_fn: callable(images) -> relevance maps, same shape.
    :param score_fn: callable(images, labels) -> scalar score (the reference
        uses ``model.test_on_batch``; any metric works).
    :param batches: list of (images, labels) numpy pairs.
    :param recompute_analysis: recompute maps after each perturbation step.
    """

    def __init__(self, analyze_fn, score_fn, batches, perturbation: Perturbation,
                 steps: int = 1, regions_per_step: int = 1,
                 recompute_analysis: bool = False):
        self.analyze_fn = analyze_fn
        self.score_fn = score_fn
        self.batches = list(batches)
        self.perturbation = perturbation
        self.steps = steps
        self.regions_per_step = regions_per_step
        self.recompute_analysis = recompute_analysis
        if not recompute_analysis:
            self._cached = [(x, y, np.asarray(self.analyze_fn(x))) for x, y in self.batches]

    def _evaluate(self, perturb: bool):
        scores, weights = [], []
        items = self._cached if not self.recompute_analysis else [
            (x, y, np.asarray(self.analyze_fn(x))) for x, y in self.batches]
        for x, y, analysis in items:
            xi = self.perturbation.perturbate_on_batch(x, analysis) if perturb else x
            scores.append(self.score_fn(xi, y))
            weights.append(len(x))
        return float(np.average(scores, weights=weights))

    def compute_perturbation_analysis(self):
        # the curve always starts at 1 region (perturbate.py:377); the
        # caller's configured num_perturbed_regions is restored afterwards
        # (the reference resets to the hardcoded 1, perturbate.py:395)
        prior = self.perturbation.num_perturbed_regions
        scores = [self._evaluate(perturb=False)]            # unperturbed first
        self.perturbation.num_perturbed_regions = 1
        try:
            for _ in range(self.steps):
                scores.append(self._evaluate(perturb=True))
                self.perturbation.num_perturbed_regions += self.regions_per_step
        finally:
            self.perturbation.num_perturbed_regions = prior
        assert len(scores) == self.steps + 1
        return scores
