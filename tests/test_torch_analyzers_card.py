"""PyTorch port on the card: the analyzer catalogue's kernels.

* K3's alpha-beta sibling (``kernels.lrp_conv_alpha_beta_split``) with the
  inhibitor on W- at VGG16's 12 post-ReLU conv shapes, where z is negative
  and, over a zero region of x, exactly 0;
* the names that reach K3 on the card against the port's CPU at a small
  size, with their launch counts;
* ``vgg_lrp_preset_a_imgword_batched(storage_dtype=bf16)`` through K4;
* ``compute_dtype=bf16`` launches no K3 (K3 sums to f32 accuracy, so a
  bf16-operand rule taken there would not be the JAX package's).

Marked ``cuda``: it skips where ``torch.cuda.is_available()`` is false, and
runs on an H100 with ``pytest --noconftest -m cuda`` (``chip_smoke.py``
phase 5); it imports no JAX.
"""

import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch.explain import analyzers, cnn_lrp  # noqa: E402
from lrp_imagecaptioning_torch.models.vgg import init_vgg_params, vgg_layers  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.ops.lrp_conv import lrp_conv_alpha_beta  # noqa: E402
from lrp_imagecaptioning_torch.weights import tree_to  # noqa: E402


def _vgg16_post_relu_convs():
    """(name, H = W, Cin, Cout) of VGG16's 12 convs over a post-ReLU input at 224x224."""
    size, out = 224, []
    for op in vgg_layers(until="block5_conv3"):
        if op[0] == "pool":
            size //= 2
        elif op[1] != "block1_conv1":
            out.append((op[1], size, op[2], op[3]))
    return out


CONVS = _vgg16_post_relu_convs()
UNTIL = "block2_conv1"
A1B0 = ("lrp.alpha_1_beta_0", "lrp.alpha_1_beta_0_IB", "lrp.z_plus", "lrp.z_plus_fast",
        "lrp.sequential_preset_a", "lrp.sequential_preset_a_flat", "deep_taylor",
        "deep_taylor.bounded")
A2B1 = ("lrp.alpha_2_beta_1", "lrp.alpha_2_beta_1_IB", "lrp.alpha_beta",
        "lrp.sequential_preset_b", "lrp.sequential_preset_b_flat")


def _rel(got, ref):
    return float((got.double().cpu() - ref.cpu()).abs().max() / ref.abs().max())


def _small_vgg(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = init_vgg_params(gen, until=UNTIL)
    for p in params.values():
        p["bias"] = torch.randn(p["bias"].shape, generator=gen) * 0.05
    image = torch.randn(2, 16, 16, 3, generator=gen) * 40
    seed_r = torch.randn(2, 8, 8, 128, generator=gen)
    return params, image, seed_r


@pytest.mark.cuda
class TestAnalyzersOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are built with nvcc and run only there")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @pytest.mark.parametrize("name, size, cin, cout", CONVS)
    def test_k3_alpha_beta_with_w_minus(self, name, size, cin, cout):
        """alpha2beta1 through K3 (four launches) against the plain rule in
        f64 at 1e-4 of scale, no bias: the inhibitor's z = conv(x, W-) is
        negative, and exactly 0 over the zero block of x."""
        gen = torch.Generator(device="cuda").manual_seed(size * cin + cout)
        x = torch.relu(torch.randn(1, size, size, cin, generator=gen, device="cuda"))
        x[:, : size // 2, : size // 2] = 0.0
        k = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
        r = torch.randn(2, size, size, cout, generator=gen, device="cuda")
        kp, kn = (k * (k >= 0)).contiguous(), (k * (k < 0)).contiguous()
        before = kernels.conv3x3_fused.launches
        got = kernels.lrp_conv_alpha_beta_split(r, x, kp, kn, None, 2.0, 1.0)
        assert kernels.conv3x3_fused.launches == before + 4
        z = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), kn.permute(3, 2, 0, 1), padding=1)
        assert bool((z <= 0).all()) and bool((z == 0).any())
        ref = lrp_conv_alpha_beta(r.double(), x.double(), k.double(), None, input_nonneg=True,
                                  alpha=2.0, beta=1.0)
        torch.cuda.synchronize()
        assert got.shape == (2, size, size, cin) and torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-4

    @pytest.mark.parametrize("name", A1B0 + A2B1)
    def test_k3_names_match_the_cpu(self, name):
        """Each name that reaches K3 on the card (two post-ReLU convs on this
        walk: 4 launches at alpha1beta0, 8 at alpha2beta1) against the port's
        CPU in f64, within 1e-4 of scale."""
        params, image, seed = _small_vgg()
        kw = {"low": -150.0, "high": 150.0} if name == "deep_taylor.bounded" else (
            {"alpha": 2.0, "beta": 1.0} if name == "lrp.alpha_beta" else {})
        card = analyzers.create_analyzer(name, tree_to(params, "cuda"), until=UNTIL, **kw)
        kernels.reset_launches()
        with torch.no_grad():
            got = card(image.cuda(), seed.cuda())
        assert kernels.conv3x3_fused.launches == (8 if name in A2B1 else 4)
        assert kernels.lrp_a1b0_fused.launches == 0
        ref = analyzers.create_analyzer(name, tree_to(params, dtype=torch.float64), until=UNTIL,
                                        **kw)(image.double(), seed.double())
        assert got.shape == image.shape and torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-4

    def test_imgword_batched_bf16_storage_takes_k4(self):
        """bf16 storage: K4 once per post-ReLU conv and image, the map within
        2x the CPU-bf16 run's distance from CPU f32 (or 1e-2)."""
        params, image, _ = _small_vgg(1)
        seeds = torch.randn(2, 3, 8, 8, 128, generator=torch.Generator().manual_seed(2))
        kernels.reset_launches()
        with torch.no_grad():
            got = cnn_lrp.vgg_lrp_preset_a_imgword_batched(tree_to(params, "cuda"), image.cuda(),
                                                           seeds.cuda(), until=UNTIL,
                                                           storage_dtype=torch.bfloat16)
        assert kernels.lrp_a1b0_fused.launches == 2 * 2
        assert kernels.conv3x3_fused.launches == 0
        f32 = cnn_lrp.vgg_lrp_preset_a_imgword_batched(params, image, seeds, until=UNTIL)
        cpu = cnn_lrp.vgg_lrp_preset_a_imgword_batched(params, image, seeds, until=UNTIL,
                                                       storage_dtype=torch.bfloat16)
        assert got.dtype == torch.float32 and got.shape == (2, 3, 16, 16, 3)
        assert _rel(got, f32) <= max(2 * _rel(cpu, f32), 1e-2)

    def test_compute_dtype_bf16_launches_no_k3(self):
        """bf16 operands over f32 storage take the plain rule on cuDNN: no K3,
        no K4, and the map as the CPU's within 1e-2 of scale (one bf16
        rounding of the transposed convs' outputs may flip)."""
        params, image, _ = _small_vgg(2)
        seeds = torch.randn(2, 3, 8, 8, 128, generator=torch.Generator().manual_seed(3))
        kernels.reset_launches()
        with torch.no_grad():
            got = cnn_lrp.vgg_lrp_preset_a_imgword_batched(tree_to(params, "cuda"), image.cuda(),
                                                           seeds.cuda(), until=UNTIL,
                                                           compute_dtype=torch.bfloat16)
        assert kernels.conv3x3_fused.launches == 0 and kernels.lrp_a1b0_fused.launches == 0
        cpu = cnn_lrp.vgg_lrp_preset_a_imgword_batched(params, image, seeds, until=UNTIL,
                                                       compute_dtype=torch.bfloat16)
        assert torch.isfinite(got).all() and _rel(got, cpu.double()) < 1e-2
