"""PyTorch port: its copies of the caption tokenizer and the image
preprocessing (``data/tokenizer.py``, ``data/images.py``, the native loader's
``load_batch_vgg``, ``preprocess_rgb_to_bgr``) against the JAX
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


def test_preprocess_rgb_to_bgr_matches_jax():
    from lrp_imagecaptioning_tpu.utils import visualizations as jvis
    from lrp_imagecaptioning_torch.utils import visualizations as tvis

    x = np.random.default_rng(4).uniform(0, 255, size=(2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.preprocess_rgb_to_bgr(x), jvis.preprocess_rgb_to_bgr(x))
    np.testing.assert_array_equal(tvis.preprocess_rgb_to_bgr(x)[..., 0], x[..., 2])


def test_load_batch_vgg_matches_jax(tmp_path):
    """The native loader's VGG batch: the port's binding and the JAX
    package's give the same (B, 224, 224, 3) BGR pixels. The library is
    built on demand, as tests/test_native_loader.py builds it."""
    import os
    import subprocess

    from PIL import Image

    from lrp_imagecaptioning_tpu.data import loader_native as jnat
    from lrp_imagecaptioning_torch.data import loader_native as tnat

    if not (tnat.available() and jnat.available()):
        native = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "native")
        r = subprocess.run(["make", "-C", native], capture_output=True, text=True)
        for mod in (tnat, jnat):
            mod._TRIED, mod._LIB = False, None
        if r.returncode != 0 or not (tnat.available() and jnat.available()):
            pytest.skip(f"native loader unbuildable: {r.stderr[-200:]}")
    rng = np.random.default_rng(5)
    paths = []
    for i, size in enumerate(((300, 451), (120, 90))):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray((rng.random((*size, 3)) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    got = tnat.load_batch_vgg(paths, num_threads=2)
    assert got.shape == (2, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnat.load_batch_vgg(paths, num_threads=2))
