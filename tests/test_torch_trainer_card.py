"""PyTorch port, on a machine with a card (marker ``cuda``; they skip here):
the trainer on the card against the same on the CPU, its per-epoch decode
without CUDA graphs, and grid-TD's train step through K2's Function.

* One epoch of ``Trainer.run`` (2 train steps, 1 validation step, the greedy
  decode of the test split) on the card and on the CPU from the same params:
  loss, accuracy and val_loss within 1e-4 of their scale (cuDNN and the
  kernels sum in other orders, through two Adam steps), the same learning
  rate, and K2's launches as the code derives them.
* Epochs after the first capture no CUDA graph: the bytes of the graphs'
  private pools stay as they were (the decode is eager, so a new params dict
  each epoch cannot grow a graph cache).
* grid-TD's loss gradient with K2 through its Function against the same with
  K2's plain version under autograd, both on the card: the loss within 1e-6,
  the gradients within 1e-4 of each leaf's scale, as the card against the
  CPU (K2's outputs lie up to 2.4e-7 from the plain version's, and the
  softmax gradients amplify that; phase 2c holds K2's own gradient to 1e-6;
  a dropped or misplaced gradient lies ~1 away).

The dataset is text files only, and the images are seeded arrays handed to
the provider in place of decoded files: the card's host may lack PIL.
Nothing here imports JAX: ``pytest --noconftest -m cuda`` runs it on a
machine without JAX.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.data.datasets import Flickr30kDataset  # noqa: E402
from lrp_imagecaptioning_torch.models import cells  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.train import step  # noqa: E402
from lrp_imagecaptioning_torch.train.trainer import Trainer  # noqa: E402
from lrp_imagecaptioning_torch.weights import tree_leaves, tree_to  # noqa: E402

KW = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
          img_feature_dim=128, sentence_length=6, batch_size=4, drop_rate=0.0,
          image_size=(8, 8), words_min_occur=1, rare_words_handling="nothing")
WORDS = "a the red blue dog cat ball car runs sits on in grass street near".split()


def _write_text_dataset(root):
    """Flickr30k's text files: 8 train, 4 dev, 4 test images, 3 captions each."""
    rng = np.random.default_rng(0)
    (root / "Flickr30k_text").mkdir(parents=True)
    names = [f"{i:04d}.jpg" for i in range(16)]
    lines = [f"{n}#{k}\t{' '.join(rng.choice(WORDS, size=int(rng.integers(3, 6))))} ."
             for n in names for k in range(3)]
    (root / "Flickr30k_text" / "Flickr30k.token").write_text("\n".join(lines) + "\n")
    for split, part in (("train", names[:8]), ("dev", names[8:12]), ("test", names[12:])):
        (root / "Flickr30k_text" / f"Flickr_30k.{split}Images.txt").write_text(
            "\n".join(part) + "\n")
    return str(root)


def seeded_images(paths, random_transform=False):
    """Arrays in place of decoded images, each seeded by its path."""
    return np.stack([np.random.default_rng(zlib.crc32(p.encode())).normal(
        size=(8, 8, 3)).astype(np.float32) * 30 for p in paths])


def _trainer(root, device, label):
    cfg = FlickrConfig(dataset_root=root, **KW)
    t = Trainer("adaptiveattention", cfg, Flickr30kDataset(cfg), label=label, device=device)
    t.provider.image_preprocessor.preprocess_batch_paths = seeded_images
    return t


def _pool_bytes():
    """Bytes of the device segments outside the default pool: CUDA graphs' pools."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


@pytest.mark.cuda
class TestTrainerOnCard:

    @pytest.fixture(autouse=True)
    def _card(self, tmp_path, monkeypatch):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are built with nvcc and run only there")
        monkeypatch.chdir(tmp_path)
        self.root = _write_text_dataset(tmp_path / "ds")

    def test_trainer_epoch_card_matches_cpu(self):
        trainers = {dev: _trainer(self.root, dev, f"run-{dev}") for dev in ("cpu", "cuda")}
        trainers["cuda"].params = tree_to(trainers["cpu"].params, "cuda")
        trainers["cuda"].opt_state = trainers["cuda"].optimizer.init(trainers["cuda"].params)
        out = {}
        for dev, t in trainers.items():
            kernels.reset_launches()
            hist = t.run(epochs=1, steps_per_epoch=2)
            out[dev] = (hist[0], {k.__name__: k.launches for k in kernels.KERNELS})
        (h0, n0), (h1, n1) = out["cpu"], out["cuda"]
        steps = KW["sentence_length"] + 1
        # 2 train steps and 1 validation step of T + 1 = 7 steps, the greedy decode of
        # 1 test batch (T = 6 steps)
        assert n1 == {"lrp_linear": 0, "lstm_gates": 3 * steps + KW["sentence_length"],
                      "conv3x3_fused": 0, "lrp_a1b0_fused": 0}
        assert n0 == dict.fromkeys(n1, 0)
        for k in ("loss", "accuracy", "val_loss"):
            assert abs(h1[k] - h0[k]) <= 1e-4 * max(abs(h0[k]), 1e-6), (k, h1[k], h0[k])
        assert h1["learning_rate"] == h0["learning_rate"]
        assert "dev0_peak_bytes_mb" in h1

    def test_epochs_capture_no_graph(self):
        t = _trainer(self.root, "cuda", "graphs")
        t.run(epochs=1, steps_per_epoch=1)
        before = _pool_bytes()
        assert t.resume_latest()
        hist = t.run(epochs=3, steps_per_epoch=1)
        assert len(hist) == 2
        assert _pool_bytes() == before

    @pytest.mark.parametrize("loss_mode", ["from_logits", "keras_categorical"])
    def test_gridtd_train_step_k2_gradient_matches_plain_autograd(self, loss_mode, monkeypatch):
        cfg = FlickrConfig(**KW, loss_mode=loss_mode)
        cap = build_captioner("gridTD", cfg, 24)
        params = cap.init_params(seed=1, device="cuda")
        rng = np.random.default_rng(2)
        images = torch.from_numpy(rng.normal(size=(4, 8, 8, 3)).astype(np.float32)).cuda() * 30
        caps = torch.from_numpy(rng.integers(0, 24, size=(4, 7))).cuda()
        y = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, 24, size=(4, 7))),
                                        24).float().cuda()
        grads = {}
        for k2 in ("function", "plain"):
            if k2 == "plain":
                monkeypatch.setattr(cells, "lstm_gates", kernels.lstm_gates_plain)
            kernels.reset_launches()
            loss, _, g = step.value_and_grad(
                lambda p: (cap.loss(p, images, caps, y), None), params)
            grads[k2] = (loss, tree_leaves(g), kernels.lstm_gates.launches)
        (l0, g0, n0), (l1, g1, n1) = grads["plain"], grads["function"]
        assert n1 == 2 * 7 and n0 == 0          # two LSTMs a step through the kernel
        assert abs(l1.item() - l0.item()) <= 1e-6 * abs(l0.item())
        for a, b in zip(g0, g1):
            assert ((b - a).abs().max() / a.abs().max().clamp(min=1e-30)).item() <= 1e-4
