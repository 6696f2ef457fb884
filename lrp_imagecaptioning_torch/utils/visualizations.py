"""Heatmap rendering utilities (host numpy; rendering never touches the card).

The port's copy of the JAX package's ``utils/visualizations.py``: the
vendored iNNvestigate helpers the reference drivers use
(innvestigate/utils/visualizations.py:36-145 and
examples/utils_imagenet.py:14-37): value projection, seismic-colormap
heatmaps, graymaps, gamma correction, quantile clipping, and the
``postprocess`` channel/color re-coding applied to CNN relevance before
rendering. matplotlib is imported inside ``heatmap`` only.
"""

from __future__ import annotations

import numpy as np


def preprocess_rgb_to_bgr(x: np.ndarray) -> np.ndarray:
    """Reverse the channel axis (examples/utils_imagenet.py): RGB -> BGR."""
    return x[..., ::-1]


def postprocess(X: np.ndarray, color_coding: str | None = None,
                channels_first: bool = False) -> np.ndarray:
    """utils_imagenet.postprocess (examples/utils_imagenet.py:14-24):
    move channels last, then optionally convert BGR->RGB."""
    x = np.asarray(X).copy()
    if channels_first:
        x = np.moveaxis(x, 1, -1)
    if color_coding == "BGRtoRGB":
        x = x[..., ::-1]
    return x


def project(X: np.ndarray, output_range=(0, 1), absmax: np.ndarray | None = None,
            input_is_positive_only: bool = False) -> np.ndarray:
    """Per-sample linear projection into ``output_range``
    (visualizations.py:36-61): divide by max|x| over non-batch axes, shift
    [-1,1] -> [0,1] unless positive-only, then scale."""
    X = np.asarray(X, dtype=np.float64).copy()
    if absmax is None:
        absmax = np.max(np.abs(X), axis=tuple(range(1, X.ndim)), keepdims=True)
    absmax = np.asarray(absmax)
    mask = absmax != 0
    X = np.where(mask, X / np.where(mask, absmax, 1.0), X)
    if not input_is_positive_only:
        X = (X + 1) / 2
    X = X.clip(0, 1)
    return output_range[0] + (X * (output_range[1] - output_range[0]))


def heatmap(X: np.ndarray, cmap_type: str = "seismic", reduce_axis: int = -1, **kw) -> np.ndarray:
    """Relevance -> RGB heatmap via the seismic colormap
    (visualizations.py:64-84): channel-sum, project to [0,1], colormap."""
    from matplotlib import cm

    summed = np.asarray(X).sum(axis=reduce_axis)
    projected = project(summed, output_range=(0, 1), **kw)
    return getattr(cm, cmap_type)(projected)[..., :3]


def graymap(X: np.ndarray, **kw) -> np.ndarray:
    """Gradient magnitude -> gray image (visualizations.py:87-92)."""
    summed = np.abs(np.asarray(X)).sum(axis=-1, keepdims=True)
    projected = project(summed, output_range=(0, 1), input_is_positive_only=True, **kw)
    return np.repeat(projected, 3, axis=-1)


def gamma(X: np.ndarray, gamma_value: float = 0.5, minamp: float = 0.0) -> np.ndarray:
    """Gamma correction preserving sign (visualizations.py:95-118)."""
    X = np.asarray(X, dtype=np.float64).copy()
    pos = X > minamp
    neg = X < -minamp
    out = np.zeros_like(X)
    amp = np.abs(X) - minamp
    out[pos] = np.power(amp[pos], gamma_value) + minamp
    out[neg] = -(np.power(amp[neg], gamma_value) + minamp)
    return out


def clip_quantile(X: np.ndarray, quantile: float = 1.0) -> np.ndarray:
    """Symmetric percentile clipping (visualizations.py:121-133).

    ``quantile`` in percent (e.g. 1 clips below p1 / above p99)."""
    X = np.asarray(X, dtype=np.float64).copy()
    lo = np.percentile(X, quantile)
    hi = np.percentile(X, 100 - quantile)
    X[X < lo] = lo
    X[X > hi] = hi
    return X
