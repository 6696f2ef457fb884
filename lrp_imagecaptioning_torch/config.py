"""Run configuration for the PyTorch port.

The port's own copy of the JAX package's ``config.py``: the same dataclasses
(``Config``, ``FlickrConfig``, ``COCOConfig``, ``COCO2014Config``) with the
same field names and defaults, and the run snapshot ``save_yaml``
(reference: config.py:58-88).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    """Base hyperparameters shared by all datasets (reference config.py:6-56)."""

    # optimization
    learning_rate: float = 2e-4
    batch_size: int = 32
    epochs: Optional[int] = None
    time_limit: Optional[str] = None
    reduce_lr_factor: float = 0.5
    reduce_lr_patience: int = 2

    # model dims
    embedding_dim: int = 512
    hidden_dim: int = 512
    drop_rate: float = 0.5
    l1_reg: float = 0.0
    l2_reg: float = 0.0
    rnn_type: str = "lstm"
    rnn_layers: int = 1
    bidirectional_rnn: bool = False
    pretrained_word_vector: Optional[str] = None  # None | 'glove' | 'fasttext'

    # captions
    sentence_length: int = 20          # T: max caption length
    rare_words_handling: str = "discard"
    words_min_occur: int = 3

    # encoder
    img_encoder: str = "vgg16"
    layer_name: str = "block5_conv3"   # feature tap
    img_feature_length: int = 196      # L = 14*14
    img_feature_dim: int = 512         # D
    image_augmentation: bool = False
    # None = the encoder's default input size (224 for vgg16); an override
    # such as (32, 32) shrinks the pipeline for tests
    image_size: tuple | None = None

    # 'float32' | 'bfloat16': the encoder's conv operands (Captioner.encode)
    compute_dtype: str = "float32"
    remat_encoder: bool = False        # recompute the CNN in the backward pass
    # 'from_logits' = softmax-CE on logits; 'keras_categorical' = the
    # reference grid-TD's categorical_crossentropy on raw logits
    # (model.py:662-664), used for gridTD only
    loss_mode: str = "from_logits"

    dataset_name: str = ""

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save_yaml(self, path: str) -> None:
        """Snapshot the run config (save_config_as_dict, config.py:58-88), as
        the JAX package writes it."""
        import yaml

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.as_dict(), f, default_flow_style=False)


@dataclass
class FlickrConfig(Config):
    """Flickr30k defaults (reference: config.py:6-56)."""

    dataset_name: str = "flickr30k"
    learning_rate: float = 2e-4
    batch_size: int = 32
    words_min_occur: int = 3

    # file layout (relative to dataset_root)
    dataset_root: str = "dataset"
    caption_filename: str = "Flickr30k_text/Flickr30k.token"
    image_dir: str = "Flickr30k_images"
    train_image_list: str = "Flickr30k_text/Flickr_30k.trainImages.txt"
    dev_image_list: str = "Flickr30k_text/Flickr_30k.devImages.txt"
    test_image_list: str = "Flickr30k_text/Flickr_30k.testImages.txt"
    entities_json: str = "Flickr30kEntities.json"


@dataclass
class COCOConfig(Config):
    """MSCOCO-2017 defaults (reference: config.py:90-155)."""

    dataset_name: str = "coco"
    learning_rate: float = 5e-4
    batch_size: int = 20
    words_min_occur: int = 5

    dataset_root: str = "dataset/coco2017"
    train_caption_json: str = "annotations/captions_train2017.json"
    val_caption_json: str = "annotations/captions_val2017.json"
    train_image_dir: str = "train2017"
    val_image_dir: str = "val2017"
    train_size: int = 110000           # sorted img-ids sliced (preparedataset.py:300)
    val_size: int = 5000
    entities_json: str = "COCOvalEntities.json"


@dataclass
class COCO2014Config(COCOConfig):
    """Karpathy-split COCO2014 (reference: config.py:189-196)."""

    dataset_name: str = "coco2014"
    dataset_root: str = "dataset/coco2014"
    karpathy_json: str = "dataset_coco.json"
