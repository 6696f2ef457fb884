"""PyTorch port: its copies of the caption tokenizer and the image
preprocessing (``data/tokenizer.py``, ``data/images.py``) against the JAX
package's classes on the same captions and images: the same ids, the same
``word_of``, the same padded batches, the same preprocessed pixels and the
same random augmentation from the same seed.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from lrp_imagecaptioning_tpu.data import images as jimg  # noqa: E402
from lrp_imagecaptioning_tpu.data import tokenizer as jtok  # noqa: E402
from lrp_imagecaptioning_torch.data import images as timg  # noqa: E402
from lrp_imagecaptioning_torch.data import tokenizer as ttok  # noqa: E402

CAPTIONS = ["A dog runs on the grass.", "Two dogs play; a dog sleeps!", "a man rides a horse",
            "The man, the dog and the horse.", "a dog", "rare words appear once"]


@pytest.mark.parametrize("rare", ["discard", "nothing"])
def test_caption_preprocessor_matches_jax(rare):
    j, t = jtok.CaptionPreprocessor(rare, 2), ttok.CaptionPreprocessor(rare, 2)
    j.fit_on_captions(CAPTIONS)
    t.fit_on_captions(CAPTIONS)
    assert t.word_of == j.word_of and t.vocabs == j.vocabs and t.vocab_size == j.vocab_size
    assert (t.SOS_TOKEN_LABEL_ENCODED, t.EOS_TOKEN_LABEL_ENCODED) == \
        (j.SOS_TOKEN_LABEL_ENCODED, j.EOS_TOKEN_LABEL_ENCODED)
    enc = t.encode_captions(CAPTIONS)
    assert enc == j.encode_captions(CAPTIONS)
    assert t.decode_captions_from_list2d(enc) == j.decode_captions_from_list2d(enc)
    assert t.decode_captions_from_list1d(enc[0]) == j.decode_captions_from_list1d(enc[0])
    assert t.normalize_captions(CAPTIONS) == j.normalize_captions(CAPTIONS)
    for maxlen in (None, 4):
        for a, b in zip(t.preprocess_batch(enc, maxlen), j.preprocess_batch(enc, maxlen)):
            np.testing.assert_array_equal(a, b)


def test_text_to_word_sequence_matches_jax():
    for text in CAPTIONS + ["Tab\tand\nnewline", "", "  spaced  out "]:
        assert ttok.text_to_word_sequence(text) == jtok.text_to_word_sequence(text)


def _png(tmp_path, name, size, seed, mode="RGB"):
    from PIL import Image

    arr = np.random.default_rng(seed).uniform(0, 255, size=(*size, 3)).astype("uint8")
    path = str(tmp_path / name)
    Image.fromarray(arr).convert(mode).save(path)
    return path


def test_vgg_preprocess_and_deprocess_match_jax():
    x = np.random.default_rng(3).uniform(0, 255, size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(timg.vgg_preprocess(x), jimg.vgg_preprocess(x))
    y = timg.vgg_preprocess(x)
    np.testing.assert_array_equal(timg.vgg_deprocess(y), jimg.vgg_deprocess(y))
    np.testing.assert_allclose(timg.vgg_deprocess(y), x, atol=1e-4)


def test_image_preprocessor_matches_jax(tmp_path):
    paths = [_png(tmp_path, "a.png", (12, 10), 1), _png(tmp_path, "b.png", (8, 8), 2, "L")]
    for size in ((8, 8), None):
        t = timg.ImagePreprocessor(image_size=size)
        j = jimg.ImagePreprocessor(image_size=size)
        np.testing.assert_array_equal(t.preprocess_batch_paths(paths),
                                      j.preprocess_batch_paths(paths))
    # the random transform draws the same parameters from the same seed
    t = timg.ImagePreprocessor(image_augmentation=True, seed=5, image_size=(8, 8))
    j = jimg.ImagePreprocessor(image_augmentation=True, seed=5, image_size=(8, 8))
    for _ in range(3):
        np.testing.assert_array_equal(t.preprocess_images(paths, random_transform=True),
                                      j.preprocess_images(paths, random_transform=True))
    # every encoder: caffe BGR at 224x224 for VGG and ResNet, [-1, 1] at
    # 299x299 for InceptionV3; an unknown encoder raises
    for encoder in ("vgg19", "resnet50", "resnet101", "inception_v3"):
        t = timg.ImagePreprocessor(encoder=encoder)
        j = jimg.ImagePreprocessor(encoder=encoder)
        np.testing.assert_array_equal(t.preprocess_batch_paths(paths),
                                      j.preprocess_batch_paths(paths))
    with pytest.raises(ValueError, match="encoder"):
        timg.ImagePreprocessor(encoder="resnet152")


@pytest.mark.parametrize("kw", [dict(theta=30.0), dict(tx=2.0, ty=-1.5), dict(shear=0.2),
                                dict(zx=0.9, zy=1.1), dict(theta=-12.0, tx=1.0, zx=1.2), {}])
def test_apply_affine_transform_matches_jax(kw):
    x = np.random.default_rng(4).uniform(0, 255, size=(9, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(timg.apply_affine_transform(x, **kw),
                                  jimg.apply_affine_transform(x, **kw))
