"""The work counts against hand counts at tiny shapes."""

from perfbench.reference.model import Sizes
from perfbench.work import cnn, decoder


def test_vgg_counts_by_hand():
    # block1_conv1 (3->64) and block1_conv2 (64->64) at 4x4
    c1, c2 = 2 * 16 * 9 * 3 * 64, 2 * 16 * 9 * 64 * 64
    assert cnn.forward_flops("vgg16", "block1_conv2", 4) == c1 + c2
    assert cnn.train_flops("vgg16", "block1_conv2", 4) == 3 * (c1 + c2) - c1
    # PresetA for 3 words: forward, the post-ReLU conv's z once and its
    # transpose 3 times, the image layer's two z and two transposes a word
    assert cnn.lrp_flops("vgg16", "block1_conv2", 4, 3) == (c1 + c2) + 4 * c2 + 2 * 4 * c1


def test_rule_work_by_hand():
    hw, ci, co, w = 16, 64, 64, 3
    conv = 2 * hw * 9 * ci * co
    ops, nbytes = cnn.rule_work("vgg16", "block1_conv2", 4, w, "k3")
    assert ops == conv * (1 + w)
    assert nbytes == 4 * (w * hw * co + hw * ci + 9 * ci * co + co + w * hw * ci)
    ops, nbytes = cnn.rule_work("vgg16", "block1_conv2", 4, w, "k4")
    assert ops == conv * w
    assert nbytes == 2 * (w * hw * co + hw * co + hw * ci + 9 * ci * co + w * hw * ci)


def test_pools_halve_the_size():
    layers = cnn.conv_layers("vgg16", "block5_conv3", 224)
    assert [s for _, s, _, _ in layers] == [224] * 2 + [112] * 2 + [56] * 3 + [28] * 3 + [14] * 3


def test_decoder_counts_by_hand():
    s = Sizes("adaptiveattention", "vgg16", "block5_conv3", E=2, H=3, L=4, D=5, V=7, image=8)
    step = (2 * (4 * 4 * 3 + 3 * 4 * 3) + 2 * (9 + 12 + 12 + 9 + 3) + 2 * (4 * 3 + 9)
            + 2 * 3 * 7)
    assert decoder.step_flops(s) == step
    assert decoder.forward_flops(s, 2) == 2 * (4 * 5 * 3 + 5 * 2 + 4 * 9) + 2 * step
    assert decoder.lrp_word_flops(s, 1) == 2 * (3 * 7 + 2 * 7 * 3 + 2 * 5 + 4 * 3 * 5)
