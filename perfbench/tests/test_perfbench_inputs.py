"""The inputs a run makes from its seed."""

import numpy as np
import torch

from perfbench.harness import inputs
from perfbench.harness.cell import load_cell

LAW = {"mean": 10.0, "std": 3.0, "min": 4, "max": 20}


def _draw(seed):
    s = load_cell("adaptive-explain-natural", rehearsal=True).sizes
    gen = inputs.generator(seed, 10, "cpu")
    imgs = inputs.images(8, 16, gen)
    toks, lengths = inputs.captions(8, LAW, s.V, 20, gen)
    params = inputs.make_params(s, seed, "cpu")
    return imgs, toks, lengths, params


def test_same_seed_same_inputs():
    a, b = _draw(2**33 + 5), _draw(2**33 + 5)
    assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert torch.equal(a[3]["decoder"]["output"]["kernel"], b[3]["decoder"]["output"]["kernel"])


def test_other_seed_other_inputs_same_lengths():
    a, b = _draw(1), _draw(2)
    assert not torch.equal(a[0], b[0]) and not np.array_equal(a[1], b[1])
    assert not torch.equal(a[3]["vgg"]["block1_conv1"]["kernel"],
                           b[3]["vgg"]["block1_conv1"]["kernel"])
    # every seed hands the program the same multiset of caption lengths
    assert sorted(a[2]) == sorted(b[2]) == sorted(inputs.natural_lengths(8, LAW))


def test_caption_rows():
    toks, lengths = inputs.captions(64, LAW, 7003, 20, inputs.generator(3, 0, "cpu"))
    for row, n in zip(toks, lengths):
        assert (row[:n] >= inputs.FIRST_WORD).all() and (row[:n] <= 7003).all()
        assert n == 20 or (row[n] == inputs.EOS and (row[n + 1:] == 0).all())


def test_natural_lengths_follow_the_law():
    n = inputs.natural_lengths(224, LAW)
    assert n.min() >= 4 and n.max() <= 20 and abs(n.mean() - 10.0) < 0.1


def test_training_batch_shifts_the_caption():
    toks = np.array([[5, 6, inputs.EOS, 0]])
    cap_in, y = inputs.training_batch(toks, 5, 10, "cpu")
    assert cap_in.tolist() == [[0, 4, 5, 1, 0]]          # SOS, words, EOS, 0-based
    assert y.argmax(-1)[0, :3].tolist() == [4, 5, 1] and y[0, 3:].sum() == 0


def test_the_check_samples_every_chunk_of_every_pool():
    from perfbench.entries.explain import chunks, sample_rows

    pools = [inputs.captions(224, LAW, 7003, 20, inputs.generator(9, 10 + p, "cpu"))[1]
             for p in range(4)]
    a, b = sample_rows(pools, 56, 1, 2**40 + 3), sample_rows(pools, 56, 1, 2**40 + 3)
    assert a == b and a != sample_rows(pools, 56, 1, 7)
    for rows, lengths in zip(a, pools):
        parts = chunks(lengths, 56)
        assert len(parts) == 4 and 4 <= len(rows) <= 5
        for chunk in parts:
            assert set(rows) & set(int(r) for r in chunk)
    assert int(np.argmax(pools[0])) in a[0]
