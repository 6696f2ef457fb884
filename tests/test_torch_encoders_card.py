"""PyTorch port on the card: K3 (``conv3x3_fused``) at the ResNet and
Inception shapes the LRP walks give it, and the Inception walk's concat
split, which hands K3 a sliced relevance.

Marked ``cuda``: it skips where ``torch.cuda.is_available()`` is false, and
runs on an H100 with ``pytest --noconftest -m cuda`` (``chip_smoke.py``
phase 5); it imports no JAX.
"""

import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch.explain import cnn_lrp, inception_lrp  # noqa: E402
from lrp_imagecaptioning_torch.models import inception  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402

# (H = W, Cin, Cout) of the 3x3 SAME stride-1 convs over post-ReLU inputs:
# Inception at 299x299 (stem3, the mixed blocks' b3x3dbl convs), ResNet at
# 224x224 (each stage's 2b conv); 147, 35 and 7 leave partial tiles
SHAPES = [(147, 32, 64), (35, 64, 96), (35, 96, 96), (8, 448, 384),
          (56, 64, 64), (28, 128, 128), (14, 256, 256), (7, 512, 512)]


def _rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
class TestEncodersOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are built with nvcc and run only there")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @pytest.mark.parametrize("size, cin, cout", SHAPES)
    def test_k3_at_the_encoders_shapes(self, size, cin, cout):
        """Both passes of the alpha1beta0 pair, bias-free as on ResNet and
        Inception, x shared by 4 word seeds: against the plain version in f64
        at 1e-4 of scale (3xTF32, the tolerance of the VGG shapes' card test)."""
        gen = torch.Generator(device="cuda").manual_seed(size * cin + cout)
        n = 4
        x = torch.relu(torch.randn(1, size, size, cin, generator=gen, device="cuda"))
        kp = torch.rand(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
        r = torch.randn(n, size, size, cout, generator=gen, device="cuda")
        kt = kernels.flip_transpose_kernel(kp)
        s = kernels.conv3x3_fused(x, r, kp, None, "divide")
        out = kernels.conv3x3_fused(s, x, kt, None, "multiply")
        s64 = kernels.conv3x3_fused_plain(x.double(), r.double(), kp.double(), None, "divide")
        out64 = kernels.conv3x3_fused_plain(s.double(), x.double(), kt.double(), None, "multiply")
        torch.cuda.synchronize()
        assert s.shape == (n, size, size, cout) and out.shape == (n, size, size, cin)
        assert _rel(s, s64) < 1e-4 and _rel(out, out64) < 1e-4

    def test_concat_slice_reaches_k3_contiguous(self):
        """A concat's channel slice is strided: K3's wrapper refuses it, and
        ``conv_rule`` copies it first, so the rule launches K3 twice and
        gives what the contiguous relevance gives."""
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.relu(torch.randn(1, 35, 35, 64, generator=gen, device="cuda"))
        k = torch.randn(3, 3, 64, 96, generator=gen, device="cuda") / 24
        whole = torch.randn(3, 35, 35, 288, generator=gen, device="cuda")
        r = whole[..., 64:160]
        assert not r.is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            kernels.conv3x3_fused(x, r, k.clamp(min=0).contiguous(), None, "divide")
        before = kernels.conv3x3_fused.launches
        got = cnn_lrp.conv_rule(r, x, k, None)
        assert kernels.conv3x3_fused.launches == before + 2
        ref = cnn_lrp.conv_rule(r.contiguous(), x, k, None)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)

    @pytest.mark.parametrize("window, stride, padding", [(3, 1, "SAME"), (3, 2, "VALID")])
    def test_average_pool_gradient_matches_the_cpu(self, window, stride, padding):
        """Autograd through ``avgpool2d`` (Inception's SAME pools, which the
        gradient methods differentiate) against the CPU in f64: PyTorch's
        CUDA avg_pool2d backward over a channels-last view returned a wrong
        gradient (1.1 of scale on an H100), so the op pools an NCHW copy."""
        from lrp_imagecaptioning_torch.ops.lrp_conv import avgpool2d

        gen = torch.Generator().manual_seed(window + stride)
        x = torch.randn(2, 17, 17, 96, generator=gen, dtype=torch.float64)
        grads = []
        for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
            xd = x.to(dev, dt).requires_grad_()
            y = avgpool2d(xd, window, stride, padding=padding)
            cot = torch.randn(y.shape, generator=gen, dtype=torch.float64) if dev == "cpu" else cot
            grads.append(torch.autograd.grad(y, xd, cot.to(dev, dt))[0])
        assert _rel(grads[1].cpu(), grads[0]) < 1e-6

    def test_inception_walk_launches_k3_and_matches_the_cpu(self):
        """The whole Inception LRP walk at 75x75 (random params, BatchNorm
        statistics drawn), two word seeds: K3 twice on each of its 10 convs,
        and the map's distance from the CPU's f64 walk, by the 2-norm, within
        2x the CPU-f32 walk's (floor 1e-3). With drawn BN statistics the BN
        rule divides by (x - mean) y near 0 in places, and f32 alone moves
        the map ~3e-2 from f64 on the CPU."""
        gen = torch.Generator().manual_seed(0)
        params = inception.init_inception_v3_params(gen)
        for p in params.values():
            p["bn_gamma"] = torch.rand(p["bn_gamma"].shape, generator=gen) + 0.5
            p["bn_var"] = torch.rand(p["bn_var"].shape, generator=gen) + 0.5
            p["bn_beta"] = torch.randn(p["bn_beta"].shape, generator=gen) * 0.1
            p["bn_mean"] = torch.randn(p["bn_mean"].shape, generator=gen) * 0.1
        image = torch.randn(1, 75, 75, 3, generator=gen) * 0.5
        seeds = torch.randn(2, 1, 1, 2048, generator=gen)
        ref = inception_lrp.inception_lrp_wordbatched(params, image, seeds)
        ref64 = inception_lrp.inception_lrp_wordbatched(
            {k: {n: t.double() for n, t in v.items()} for k, v in params.items()},
            image.double(), seeds.double())
        card = {k: {n: t.cuda() for n, t in v.items()} for k, v in params.items()}
        before = kernels.conv3x3_fused.launches
        with torch.no_grad():
            got = inception_lrp.inception_lrp_wordbatched(card, image.cuda(), seeds.cuda())
        torch.cuda.synchronize()
        assert kernels.conv3x3_fused.launches == before + 20
        l2 = lambda a: float((a.double().cpu() - ref64).norm() / ref64.norm())  # noqa: E731
        assert l2(got) <= max(2.0 * l2(ref), 1e-3), (l2(got), l2(ref))
