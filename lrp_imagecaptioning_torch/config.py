"""Run configuration for the PyTorch port.

The port's own copy of the fields of the JAX package's ``Config`` /
``FlickrConfig`` that the caption + explain path, the Explainer, the parity
command and the training path read, with the same names and defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class Config:
    """Base hyperparameters (reference config.py:6-56)."""

    # optimization
    learning_rate: float = 2e-4
    batch_size: int = 32

    # model dims
    embedding_dim: int = 512
    hidden_dim: int = 512
    drop_rate: float = 0.5

    # captions
    sentence_length: int = 20          # T: max caption length

    # encoder
    img_encoder: str = "vgg16"
    layer_name: str = "block5_conv3"   # feature tap
    img_feature_length: int = 196      # L = 14*14
    img_feature_dim: int = 512         # D
    # None = the encoder's default input size (224 for vgg16); an override
    # such as (32, 32) shrinks the pipeline for tests
    image_size: tuple | None = None

    dataset_name: str = ""

    # 'float32' | 'bfloat16': the encoder's conv operands (Captioner.encode)
    compute_dtype: str = "float32"
    remat_encoder: bool = False        # recompute the CNN in the backward pass

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


@dataclass
class FlickrConfig(Config):
    """Flickr30k defaults."""

    dataset_name: str = "flickr30k"
    learning_rate: float = 2e-4
    batch_size: int = 32
