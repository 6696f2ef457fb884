"""Host-side image loading + preprocessing (numpy).

The port's own copy of the JAX package's ``data/images.py``: load -> resize
-> the encoder's preprocessing. VGG and ResNet take 224x224 RGB->BGR with
the ImageNet mean subtracted (the Keras 'caffe' convention); InceptionV3
takes 299x299 scaled to [-1, 1]. And the training
augmentation (rotation/shift/shear/zoom/hflip) with the same parameter
draws. PIL is imported inside ``load_img_array`` and scipy inside
``apply_affine_transform`` only: the machine with the card has neither
installed for certain, and nothing on the card's path reads a file.
"""

from __future__ import annotations

import numpy as np

IMAGE_SIZE = (224, 224)
# Keras 'caffe' mode BGR means (keras_applications/imagenet_utils.py)
VGG_BGR_MEAN = np.array([103.939, 116.779, 123.68], dtype=np.float32)


def load_img_array(img_path: str, target_size=IMAGE_SIZE) -> np.ndarray:
    """PIL load + nearest resize to ``target_size`` (rows, cols), float32 RGB HWC."""
    from PIL import Image

    img = Image.open(img_path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    if img.size != (target_size[1], target_size[0]):
        img = img.resize((target_size[1], target_size[0]), Image.NEAREST)
    return np.asarray(img, dtype=np.float32)


def vgg_preprocess(img_rgb: np.ndarray) -> np.ndarray:
    """RGB float HWC (0..255) -> BGR mean-subtracted (vgg16.preprocess_input)."""
    x = img_rgb[..., ::-1].astype(np.float32)  # RGB->BGR
    return x - VGG_BGR_MEAN


def vgg_deprocess(img_bgr: np.ndarray) -> np.ndarray:
    """Inverse of vgg_preprocess: BGR mean-subtracted -> RGB 0..255."""
    x = img_bgr + VGG_BGR_MEAN
    return x[..., ::-1]


ENCODERS = ("vgg16", "vgg19", "resnet50", "resnet101", "inception_v3")
INCEPTION_SIZE = (299, 299)


def encoder_image_size(encoder: str):
    """The encoder's input size (rows, cols): 299x299 for InceptionV3, else 224x224."""
    return INCEPTION_SIZE if encoder == "inception_v3" else IMAGE_SIZE


class ImagePreprocessor:
    """The reference ImagePreprocessor (preprocessors.py:10-53) for every encoder."""

    def __init__(self, encoder: str = "vgg16", image_augmentation: bool = False, seed: int = 0,
                 image_size=None):
        if encoder not in ENCODERS:
            raise ValueError(f"encoder {encoder!r} not in {ENCODERS}")
        self.encoder = encoder
        self._size = tuple(image_size) if image_size is not None else encoder_image_size(encoder)
        self._augment = image_augmentation
        self._rng = np.random.default_rng(seed)

    def preprocess_images(self, img_paths, random_transform: bool = False):
        return [self._preprocess_one(p, random_transform) for p in img_paths]

    def preprocess_batch(self, img_list) -> np.ndarray:
        return np.asarray(img_list, dtype=np.float32)

    def preprocess_batch_paths(self, img_paths, random_transform: bool = False) -> np.ndarray:
        """(B, H, W, 3) float32. The native loader takes the batch when it is
        built, the size is square and no augmentation is asked for, as in the
        JAX package; an image it cannot decode sends the batch down the PIL
        path."""
        from . import loader_native

        if (self._size[0] == self._size[1] and loader_native.available()
                and not (self._augment and random_transform)):
            mode = "inception" if self.encoder == "inception_v3" else "caffe"
            try:
                return loader_native.load_batch(list(img_paths), self._size[0], mode)
            except RuntimeError:
                pass
        return self.preprocess_batch(self.preprocess_images(img_paths, random_transform))

    def _preprocess_one(self, img_path: str, random_transform: bool) -> np.ndarray:
        arr = load_img_array(img_path, target_size=self._size)
        if self._augment and random_transform:
            arr = self._random_transform(arr)
        if self.encoder == "inception_v3":
            from ..models.inception import inception_preprocess

            return inception_preprocess(arr)
        return vgg_preprocess(arr)

    # -- augmentation (reference params: rotation 40, shifts 0.2, shear 0.2,
    #    zoom 0.2, hflip — preprocessors.py:18-25) -------------------------

    def _random_transform(self, x: np.ndarray) -> np.ndarray:
        # ImageDataGenerator.get_random_transform's draws for the reference's
        # config: theta and shear in DEGREES (shear_range=0.2 is +-0.2 deg),
        # shifts scaled by the image dims, zoom in [0.8, 1.2], hflip p=.5
        theta = self._rng.uniform(-40, 40)
        tx = self._rng.uniform(-0.2, 0.2) * x.shape[0]
        ty = self._rng.uniform(-0.2, 0.2) * x.shape[1]
        shear = self._rng.uniform(-0.2, 0.2)
        zx, zy = self._rng.uniform(0.8, 1.2, size=2)
        flip = self._rng.random() < 0.5
        out = apply_affine_transform(x, theta, tx, ty, shear, zx, zy)
        if flip:
            out = out[:, ::-1]
        return out


def apply_affine_transform(x: np.ndarray, theta: float = 0.0, tx: float = 0.0,
                           ty: float = 0.0, shear: float = 0.0, zx: float = 1.0,
                           zy: float = 1.0) -> np.ndarray:
    """Keras ``apply_affine_transform`` for HWC arrays: ``theta``/``shear`` in
    degrees, ``tx`` shifts columns and ``ty`` rows (in pixels); the matrices
    compose rot @ shift @ shear @ zoom about (dim/2 - 0.5), bilinear sampling,
    nearest fill."""
    from scipy.ndimage import affine_transform

    h, w = x.shape[0], x.shape[1]
    theta = np.deg2rad(theta)
    shear = np.deg2rad(shear)
    m = None

    def compose(a, b):
        return b if a is None else a @ b

    if theta != 0:
        m = compose(m, np.array([[np.cos(theta), -np.sin(theta), 0],
                                 [np.sin(theta), np.cos(theta), 0],
                                 [0, 0, 1.0]]))
    if tx != 0 or ty != 0:
        m = compose(m, np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1.0]]))
    if shear != 0:
        m = compose(m, np.array([[1, -np.sin(shear), 0],
                                 [0, np.cos(shear), 0], [0, 0, 1.0]]))
    if zx != 1 or zy != 1:
        m = compose(m, np.array([[zx, 0, 0], [0, zy, 0], [0, 0, 1.0]]))
    if m is None:
        return x
    # Keras builds the matrix in (x, y) = (row, col) coordinates centred at
    # (h/2 - .5, w/2 - .5), then swaps the axes into scipy's array order
    o = np.array([h, w]) / 2.0 - 0.5
    offset_m = np.array([[1, 0, o[0]], [0, 1, o[1]], [0, 0, 1.0]])
    reset_m = np.array([[1, 0, -o[0]], [0, 1, -o[1]], [0, 0, 1.0]])
    m = offset_m @ m @ reset_m
    m[:, [0, 1]] = m[:, [1, 0]]
    m[[0, 1]] = m[[1, 0]]
    out = np.empty_like(x)
    for c in range(x.shape[2]):
        out[..., c] = affine_transform(x[..., c], m[:2, :2], offset=m[:2, 2],
                                       order=1, mode="nearest")
    return out
