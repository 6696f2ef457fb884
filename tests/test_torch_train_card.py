"""PyTorch port, on a machine with a card (marker ``cuda``; they skip here):
gradients through the kernels, and the training path on the card against the
same on the CPU.

* K2 (``lstm_gates``) runs through its autograd Function when an input
  requires grad: its gradients against autograd through the plain version,
  within 1e-6 of each gradient's scale (f32, the same formulas in another
  order of operations).
* K1, K3 and K4/K5 have no backward: under grad mode with an input that
  requires grad they raise and launch nothing; under ``no_grad`` they run.
* One train step and one fine-tune step at the CPU tests' size (VGG16 cut at
  block2_conv1, 8x8 images, E = H = 16, vocab 32) on the card and on the
  CPU, from the same params and batch: losses at rel 1e-5, gradients at 1e-4
  of each leaf's scale (cuDNN and the kernels sum in other orders), the
  fine-tune's relevance weights at 1e-3 of their scale (divides by stab(z)),
  and the kernels' launches as the code derives them.
* The loss and gradients with dropout, at the same tolerances: one set of
  masks drawn on the CPU and given to both sides.

Nothing here imports JAX: ``pytest --noconftest -m cuda`` runs it on a
machine without JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch.config import FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.models.adaptive import draw_dropout_masks  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.models.vgg import vgg_layers  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.train import lrp_finetune, step  # noqa: E402
from lrp_imagecaptioning_torch.train.optimizer import make_optimizer  # noqa: E402
from lrp_imagecaptioning_torch.weights import tree_leaves, tree_to  # noqa: E402

CFG = FlickrConfig(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1",
                   img_feature_length=16, img_feature_dim=128,
                   sentence_length=6, batch_size=4, drop_rate=0.0)
VOCAB, B, T = 32, 4, 7


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


def _batch(seed, dev):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(B, 8, 8, 3)).astype(np.float32))
    caps = torch.from_numpy(rng.integers(0, VOCAB, size=(B, T)))
    y = torch.from_numpy(np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, size=(B, T))])
    y[1, -2:] = 0
    return images.to(dev), caps.to(dev), y.to(dev)


@pytest.mark.cuda
class TestTrainingOnCard:

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are built with nvcc and run only there")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @pytest.mark.parametrize("batch,hidden", [(32, 36), (32, 512), (168, 36), (168, 512)])
    def test_lstm_gates_function_gradients(self, batch, hidden):
        gen = torch.Generator(device="cuda").manual_seed(batch * hidden)
        ins = [torch.randn(batch, 4 * hidden, generator=gen, device="cuda") * 2 for _ in range(2)]
        ins += [torch.randn(4 * hidden, generator=gen, device="cuda"),
                torch.randn(batch, hidden, generator=gen, device="cuda")]
        ins = [t.requires_grad_() for t in ins]
        before = kernels.lstm_gates.launches
        outs = kernels.lstm_gates(*ins)
        assert kernels.lstm_gates.launches == before + 1
        assert all(o.grad_fn is not None for o in outs)
        ref_outs = kernels.lstm_gates_plain(*ins)
        cot = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]
        got = torch.autograd.grad(outs, ins, cot)
        ref = torch.autograd.grad(ref_outs, ins, cot)
        for g, r in zip(got, ref):
            assert _rel(g, r) <= 1e-6

    @pytest.mark.parametrize("name", ["lrp_linear", "conv3x3_fused", "lrp_a1b0_fused"])
    def test_kernel_without_gradient_raises_under_grad_mode(self, name):
        gen = torch.Generator(device="cuda").manual_seed(3)
        if name == "lrp_linear":
            x, w = (torch.randn(s, generator=gen, device="cuda") for s in [(6, 8), (8, 12)])
            args = [torch.randn(6, 12, generator=gen, device="cuda"), x, x @ w, w]
            plain = kernels.lrp_linear_plain
        else:
            dtype = torch.float32 if name == "conv3x3_fused" else torch.bfloat16
            x = torch.rand(1, 6, 6, 8, generator=gen, device="cuda").to(dtype)
            k = torch.randn(3, 3, 8, 16, generator=gen, device="cuda").to(dtype)
            r = torch.randn(2, 6, 6, 16, generator=gen, device="cuda").to(dtype)
            # K3 in its multiply mode: well conditioned, unlike a divide by signed z
            args = [x, r, k, None, "multiply"] if name == "conv3x3_fused" else [r, x, k, None]
            plain = getattr(kernels, f"{name}_plain")
        wrapper = getattr(kernels, name)
        before = wrapper.launches
        for i in range(3):
            leaf = args[i].detach().clone().requires_grad_()
            with pytest.raises(RuntimeError, match="no gradient"):
                wrapper(*args[:i], leaf, *args[i + 1:])
        assert wrapper.launches == before                   # and no plain version ran instead
        with torch.no_grad():
            got = wrapper(*args[:2], args[2].detach().clone().requires_grad_(), *args[3:])
        assert wrapper.launches == before + 1 and not got.requires_grad
        tol = 1e-2 if name == "lrp_a1b0_fused" else 1e-4
        assert _rel(got.float(), plain(*args).float()) <= tol

    def _setup(self):
        cap = build_captioner("adaptiveattention", CFG, VOCAB)
        params = cap.init_params(seed=0, device="cpu")
        return cap, {"cpu": params, "cuda": tree_to(params, "cuda")}

    def test_train_step_card_matches_cpu(self):
        cap, params = self._setup()
        opt = make_optimizer("adaptiveattention", 1e-3)
        out = {}
        for dev in ("cpu", "cuda"):
            images, caps, y = _batch(1, dev)
            loss, _, grads = step.value_and_grad(
                lambda p: (cap.loss(p, images, caps, y), None), params[dev])
            kernels.reset_launches()
            new, state, m = step.make_train_step(cap, opt)(params[dev], opt.init(params[dev]),
                                                           images, caps, y, None)
            launches = {k.__name__: k.launches for k in kernels.KERNELS}
            out[dev] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)],
                        [t.cpu() for t in tree_leaves(new)], m["loss"].cpu(), launches)
        (l0, g0, p0, m0, n0), (l1, g1, p1, m1, n1) = out["cpu"], out["cuda"]
        assert n1 == {"lrp_linear": 0, "lstm_gates": T, "conv3x3_fused": 0, "lrp_a1b0_fused": 0}
        assert n0 == dict.fromkeys(n1, 0)
        assert abs(l1.item() - l0.item()) <= 1e-5 * abs(l0.item())
        assert abs(m1.item() - m0.item()) <= 1e-5 * abs(m0.item())
        g_max = max(g.abs().max().item() for g in g0)
        for a, b, old, new_c, new_g in zip(g0, g1, tree_leaves(params["cpu"]), p0, p1):
            assert _rel(b, a) <= 1e-4
            big = a.abs() > 1e-3 * g_max
            if big.any():
                assert _rel((new_g - old)[big], (new_c - old)[big]) <= 1e-3

    def test_dropout_loss_and_gradients_card_match_cpu(self):
        """The dropout path: gate-by-gate masked products into K2's Function,
        the masked image features, h + c_hat and logits."""
        cap, params = self._setup()
        masks = draw_dropout_masks(torch.Generator().manual_seed(7), params["cpu"]["decoder"], B,
                                   CFG, 0.5)
        out = {}
        for dev in ("cpu", "cuda"):
            images, caps, y = _batch(3, dev)
            kernels.reset_launches()
            loss, _, grads = step.value_and_grad(
                lambda p: (cap.loss(p, images, caps, y, None, masks.to(dev)), None), params[dev])
            out[dev] = (loss.cpu(), tree_to(grads, "cpu"), kernels.lstm_gates.launches)
        (l0, g0, n0), (l1, g1, n1) = out["cpu"], out["cuda"]
        assert (n0, n1) == (0, T)
        assert abs(l1.item() - l0.item()) <= 1e-5 * abs(l0.item())
        assert g1["decoder"]["lstm"]["wh"].abs().max().item() > 0
        for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
            assert _rel(b, a) <= 1e-4

    def test_finetune_step_card_matches_cpu(self):
        cap, params = self._setup()
        stop = np.zeros(VOCAB + 1, bool)
        stop[5] = True
        opt = make_optimizer("adaptiveattention", 1e-3)
        convs = sum(op[0] == "conv" for op in vgg_layers(CFG.layer_name)) - 1   # post-ReLU convs
        out = {}
        for dev in ("cpu", "cuda"):
            images, caps, y = _batch(2, dev)
            ft = lrp_finetune.make_lrp_finetune_step(cap, opt, stop, 1, 2)
            y_pred = ft.phases["predict"](params[dev], images, caps)
            w = ft.phases["lrp_weights"](params[dev], images, y_pred)
            kernels.reset_launches()
            _, _, m = ft(params[dev], opt.init(params[dev]), images, caps, y, None)
            launches = {k.__name__: k.launches for k in kernels.KERNELS}
            out[dev] = (y_pred.cpu(), w.cpu(), m["loss"].cpu(), launches)
        (y0, w0, l0, n0), (y1, w1, l1, n1) = out["cpu"], out["cuda"]
        assert n1 == {"lrp_linear": T + 3, "lstm_gates": 3 * T, "conv3x3_fused": 2 * convs * B,
                      "lrp_a1b0_fused": 0}
        assert n0 == dict.fromkeys(n1, 0)
        assert torch.equal(y1.argmax(-1), y0.argmax(-1))
        assert torch.equal(w1 != 1.0, w0 != 1.0)
        assert _rel(w1 - 1.0, w0 - 1.0) <= 1e-3
        assert abs(l1.item() - l0.item()) <= 1e-5 * abs(l0.item())
