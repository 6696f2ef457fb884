"""PyTorch port, bf16 storage, against the JAX package:

* the one-kernel alpha1beta0 rule (``lrp_a1b0_fused_plain``, the plain
  version of the CUDA kernel) against the Pallas kernels it replaces,
  ``experiments/pallas_block1_v2.py``'s ``_fused_call`` (K4, both word
  packings) and ``_fused_call_v3`` (K5), run in interpret mode;
* the bf16 ops, the bf16 encode and the bf16 CNN LRP against the JAX
  package's ``compute_dtype`` / ``storage_dtype=bfloat16`` modes;
* the whole bf16 slice, ``pipeline.build(storage_dtype=bfloat16)``, against
  ``bench.build()`` in its default (bf16) mode;
* the single-seed ``vgg_lrp_preset_a`` against JAX in f32.

Tolerances. bf16 keeps 8 significant bits, a relative step of 2^-8, and the
two packages round in different places: JAX rounds the transposed conv's
output to bf16 before the x re-weight, the port's rule (like K4/K5) rounds
once after it, and the convs sum in another order. So a bf16 map is held to
an f32 anchor: its distance from the anchor, relative to the anchor's scale,
must stay within 2x that of the JAX bf16 run and within 3e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from experiments import pallas_block1_v2 as k45  # noqa: E402
from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.explain import cnn_lrp as jcnn  # noqa: E402
from lrp_imagecaptioning_tpu.models import vgg as jvgg  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build_captioner  # noqa: E402
from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv  # noqa: E402
from lrp_imagecaptioning_tpu.ops import lrp_core as jcore  # noqa: E402
from lrp_imagecaptioning_torch import pipeline  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain import cnn_lrp as tcnn  # noqa: E402
from lrp_imagecaptioning_torch.models import vgg as tvgg  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402
from lrp_imagecaptioning_torch.ops import lrp_conv as tconv  # noqa: E402
from lrp_imagecaptioning_torch.ops import lrp_core as tcore  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

BF16 = jnp.bfloat16
MAP_RTOL_BF16 = 3e-2     # of the f32 anchor's scale
ANCHOR_RATIO = 2.0       # port-bf16 vs JAX-bf16 distance from the f32 anchor
RULE_RTOL = 1e-2         # the rule against K4/K5, of the reference's scale


def _bf16_values(a):
    """f32 array holding bf16-representable values: both packages start from
    the same numbers."""
    return np.asarray(jnp.asarray(a).astype(BF16).astype(jnp.float32))


def _tb(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).bfloat16()


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dist(got, ref):
    """max |got - ref| over ref's scale."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0
    return float(np.abs(got - ref).max() / scale)


def _assert_anchored(port_bf16, jax_bf16, anchor_f32):
    d_port, d_jax = _dist(port_bf16, anchor_f32), _dist(jax_bf16, anchor_f32)
    assert d_port <= MAP_RTOL_BF16, (d_port, d_jax)
    assert d_port <= ANCHOR_RATIO * d_jax, (d_port, d_jax)


# ---------------------------------------------------------------------------
# the rule against K4 / K5
# ---------------------------------------------------------------------------

WN, HW, TH = 4, 16, 8


def _rule_inputs(seed, cin=64, cout=64, zero_patches=False):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(WN, HW, HW, cout)).astype(np.float32)
    x = np.abs(rng.normal(size=(1, HW, HW, cin))).astype(np.float32)
    k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1
    b = rng.normal(size=(cout,)).astype(np.float32) * 0.01
    if zero_patches:
        # zero bias and all-zero 3x3 windows of x: z == 0 exactly there, so
        # s = r / eps. Without the safe divide the rule gives 0 * inf = NaN.
        b[:] = 0.0
        x[:, 2:7, 3:9] = 0.0
        x[:, 11:, 12:] = 0.0
    return tuple(_bf16_values(a) for a in (r, x, k, b))


def _k5(r, x, k, b, th):
    """K5 with the input preparation of pallas_block1_v2.lrp_a1b0_fused
    (lines 251-276), r left unpadded as _fused_call_v3 takes it."""
    c = r.shape[-1]
    kp = k * (k >= 0)
    z = jax.lax.conv_general_dilated(x, kp, (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    z_pad = jnp.pad(z.astype(BF16), ((0, 0), (1, 1), (0, 0), (0, 0)), constant_values=1.0)
    taps = jnp.flip(kp, axis=(0, 1)).transpose(0, 1, 3, 2).reshape(9, c, c).astype(BF16)
    return k45._fused_call_v3(r.astype(BF16), z_pad, x.astype(BF16), taps, th, True)


TPU_KERNELS = {
    "k4": lambda r, x, k, b: k45.lrp_a1b0_fused(r, x, k, b, Th=TH, interpret=True),
    "k4_pack_words": lambda r, x, k, b: k45.lrp_a1b0_fused(r, x, k, b, Th=TH, interpret=True,
                                                           pack_words=True),
    "k5": lambda r, x, k, b: _k5(r, x, k, b, TH),
}


@pytest.mark.parametrize("zero_patches", [False, True], ids=["random", "z_zero"])
@pytest.mark.parametrize("tpu_kernel", list(TPU_KERNELS))
def test_rule_matches_k4_k5(tpu_kernel, zero_patches):
    r, x, k, b = _rule_inputs(50, zero_patches=zero_patches)
    if zero_patches:
        z = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(k * (k >= 0)))
        assert int((z == 0).sum()) > 0
    jr, jx, jk, jb = (jnp.asarray(a) for a in (r, x, k, b))
    ref = k45.reference_chain(jr, jx, jk, jb)
    tpu = TPU_KERNELS[tpu_kernel](jr, jx, jk, jb)
    got = kernels.lrp_a1b0_fused_plain(_tb(r), _tb(x), _tb(k), _tb(b), eps=k45.EPS)
    assert got.dtype == torch.bfloat16 and got.shape == (WN, HW, HW, 64)
    assert _dist(got, tpu) <= RULE_RTOL
    # the plain rule is no further from the f32 chain than the TPU kernel
    assert _dist(got, ref) <= 2.0 * _dist(tpu, ref)


@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 64)])
def test_rule_with_cin_ne_cout(cin, cout):
    """reference_chain broadcasts x to r's shape, so it takes Cin == Cout
    only; its chain for Cin != Cout is the JAX package's f32 alpha1beta0
    rule with the same eps (factor)."""
    r, x, k, b = _rule_inputs(51, cin, cout)
    jr, jk, jb = (jnp.asarray(a) for a in (r, k, b))
    jx = jnp.asarray(np.repeat(x, WN, axis=0))   # the JAX rule takes x per seed
    for eps in (k45.EPS, jcore.EPS_KERAS):
        ref = jconv.lrp_conv_alpha_beta(jr, jx, jk, jb, 1.0, 0.0, factor=eps, input_nonneg=True)
        got = kernels.lrp_a1b0_fused_plain(_tb(r), _tb(x), _tb(k), _tb(b), eps=eps)
        assert got.shape == (WN, HW, HW, cin)
        assert _dist(got, ref) <= RULE_RTOL
    # the wrapper takes the plain version, eps = 1e-7, for a CPU tensor
    launches = kernels.lrp_a1b0_fused.launches
    wrapped = kernels.lrp_a1b0_fused(_tb(r), _tb(x), _tb(k), _tb(b))
    assert kernels.lrp_a1b0_fused.launches == launches
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# bf16 ops and encode
# ---------------------------------------------------------------------------


def test_safe_divide_bf16_matches_jax():
    z = np.array([0.0, -0.0, 1e-8, -3.0, 2.5, 7.0], np.float32)
    a = np.array([1.0, -2.0, 1.0, 6.0, 1.0, 1.0], np.float32)
    got = tcore.safe_divide(_tb(a), _tb(z))
    assert got.dtype == torch.bfloat16
    ref = jcore.safe_divide(jnp.asarray(a, BF16), jnp.asarray(z, BF16))
    # one division rounded once to bf16 on both sides, eps in bf16 too
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_lrp_maxpool_wta_bf16_splits_ties_in_bf16():
    rng = np.random.default_rng(52)
    x = rng.integers(0, 3, size=(2, 8, 8, 4)).astype(np.float32)
    x[0, :2, :2, 0] = 1.0                 # a 4-way tie
    x[0, 2:4, :2, 0] = [[2.0, 2.0], [2.0, 0.0]]  # a 3-way tie: r / 3 rounds in bf16
    r = _bf16_values(rng.normal(size=(2, 4, 4, 4)))
    got = tconv.lrp_maxpool_wta(_tb(r), _tb(x))
    assert got.dtype == torch.bfloat16
    ref = jconv.lrp_maxpool_wta(jnp.asarray(r, BF16), jnp.asarray(x, BF16))
    np.testing.assert_array_equal(_np(got), _np(ref))
    third = (torch.tensor(r[0, 1, 0, 0]).bfloat16() / 3).item()
    assert _np(got)[0, 2, 0, 0] == third


def test_conv_ops_bf16_match_jax():
    rng = np.random.default_rng(53)
    x = _bf16_values(rng.normal(size=(2, 6, 8, 16)))
    k = _bf16_values(rng.normal(size=(3, 3, 16, 8)))
    s = _bf16_values(rng.normal(size=(2, 6, 8, 8)))
    y = tconv.conv2d(_tb(x), _tb(k))
    t = tconv.conv2d_input_vjp(None, _tb(k), _tb(s))
    assert y.dtype == t.dtype == torch.bfloat16
    yj = jconv.conv2d(jnp.asarray(x, BF16), jnp.asarray(k, BF16))
    tj = jconv.conv2d_input_vjp(x.shape, jnp.asarray(k, BF16), jnp.asarray(s, BF16))
    # f32 sums in another order, each rounded once to bf16: one bf16 step apart at most
    for got, ref in ((y, yj), (t, tj)):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2 ** -7, atol=1e-2)


def test_lrp_conv_alpha_beta_bf16_input_layer_matches_jax():
    """The signed image layer's split rule, run natively in bf16."""
    rng = np.random.default_rng(54)
    x = _bf16_values(rng.normal(size=(3, 8, 8, 3)))
    k = _bf16_values(rng.normal(size=(3, 3, 3, 16)) * 0.3)
    b = _bf16_values(rng.normal(size=(16,)) * 0.1)
    r = _bf16_values(rng.normal(size=(3, 8, 8, 16)))
    got = tconv.lrp_conv_alpha_beta(_tb(r), _tb(x), _tb(k), _tb(b))
    assert got.dtype == torch.bfloat16
    args = [jnp.asarray(a) for a in (r, x, k, b)]
    anchor = jconv.lrp_conv_alpha_beta(*args, 1.0, 0.0)
    jbf = jconv.lrp_conv_alpha_beta(*(a.astype(BF16) for a in args), 1.0, 0.0)
    for w in range(3):
        # the same ops rounded at the same points: at most one bf16 step apart
        # (bit-equal here), however far bf16 itself lands from the f32 rule
        assert _dist(got[w], jbf[w]) <= 2 ** -7
        assert _dist(got[w], anchor[w]) <= ANCHOR_RATIO * _dist(jbf[w], anchor[w])


def test_encode_compute_dtype_matches_jax():
    """bf16 conv operands, f32 conv output, bias and ReLU in f32; the mode
    defaults to cfg.compute_dtype, and an explicit argument overrides it."""
    kw = dict(embedding_dim=8, hidden_dim=8, layer_name="block2_conv1",
              img_feature_length=16, img_feature_dim=128)
    jcap = j_build_captioner("adaptiveattention", JConfig(compute_dtype="bfloat16", **kw), 20)
    tcap = t_build_captioner("adaptiveattention", TConfig(compute_dtype="bfloat16", **kw), 20)
    pj = {"vgg": jvgg.init_vgg_params(jax.random.PRNGKey(5), "vgg16", "block2_conv1")}
    pt = params_from_jax(pj, "cpu")
    img = np.random.default_rng(55).normal(size=(2, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jcap.encode(pj, jnp.asarray(img)))
    got = tcap.encode(pt, torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 128)
    # each conv output is rounded to bf16 once: one bf16 step of the features' scale
    assert _dist(got, ref) <= 2 ** -7
    f32 = tcap.encode(pt, torch.from_numpy(img), compute_dtype=torch.float32)
    assert not torch.equal(f32, got)
    torch.testing.assert_close(
        tvgg.vgg_apply(pt["vgg"], torch.from_numpy(img), until="block2_conv1",
                       compute_dtype=torch.bfloat16)
        .reshape(2, 16, 128), got, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the CNN LRP
# ---------------------------------------------------------------------------

UNTIL = "block2_conv2"   # reaches past the lane-packed C<=64 tail


def _cnn_inputs(n_images, n_words):
    pj = jvgg.init_vgg_params(jax.random.PRNGKey(2), "vgg16", UNTIL)
    rng = np.random.default_rng(56)
    image = rng.normal(size=(n_images, 16, 16, 3)).astype(np.float32)
    seeds = rng.normal(size=(n_words, 8, 8, 128)).astype(np.float32)
    return pj, params_from_jax(pj, "cpu"), image, seeds


@pytest.mark.parametrize("lane_pack", [False, True])
def test_cnn_lrp_bf16_matches_jax_storage_bf16(lane_pack):
    pj, pt, image, seeds = _cnn_inputs(1, 3)
    ji, js = jnp.asarray(image), jnp.asarray(seeds)
    anchor = jcnn.vgg_lrp_preset_a_wordbatched(pj, ji, js, "vgg16", UNTIL, lane_pack=lane_pack)
    jbf = jcnn.vgg_lrp_preset_a_wordbatched(pj, ji, js, "vgg16", UNTIL, compute_dtype=BF16,
                                            storage_dtype=BF16, lane_pack=lane_pack)
    launches = kernels.lrp_a1b0_fused.launches
    got = tcnn.vgg_lrp_preset_a_wordbatched(pt, torch.from_numpy(image), torch.from_numpy(seeds),
                                            until=UNTIL, storage_dtype=torch.bfloat16)
    assert kernels.lrp_a1b0_fused.launches == launches   # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (3, 16, 16, 3)
    for w in range(3):
        _assert_anchored(got[w], jbf[w], anchor[w])


def test_vgg_lrp_preset_a_matches_jax():
    """One seed per image, f32, at PR 1's bound: 1e-4 of the map's scale."""
    pj, pt, image, seeds = _cnn_inputs(2, 2)
    ref = jcnn.vgg_lrp_preset_a(pj, jnp.asarray(image), jnp.asarray(seeds), "vgg16", UNTIL)
    got = tcnn.vgg_lrp_preset_a(pt, torch.from_numpy(image), torch.from_numpy(seeds), until=UNTIL)
    assert got.shape == (2, 16, 16, 3)
    for b in range(2):
        assert _dist(got[b], ref[b]) <= 1e-4


# ---------------------------------------------------------------------------
# the whole slice against bench.build's default mode
# ---------------------------------------------------------------------------

OVERRIDES = dict(embedding_dim=16, hidden_dim=16, layer_name="block3_conv1", img_feature_length=64,
                 img_feature_dim=256, sentence_length=4, drop_rate=0.0, image_size=(32, 32))


def test_caption_and_explain_bf16_matches_bench_default(monkeypatch):
    B, V, T, K = 2, 32, 4, 3
    monkeypatch.delenv("LRPIC_BENCH_F32", raising=False)
    monkeypatch.setattr(bench, "BATCH", B)
    monkeypatch.setattr(bench, "VOCAB", V)
    monkeypatch.setattr(bench, "T", T)
    monkeypatch.setattr(bench, "BEAM", K)
    monkeypatch.setattr(bench, "CFG_OVERRIDES", OVERRIDES)
    fn_j, params_j = bench.build()                       # bench's default: bf16
    images = np.random.default_rng(57).normal(size=(B, 32, 32, 3)).astype(np.float32)
    img_j = jnp.asarray(images)
    feat_j, tok_j = fn_j.stages["caption"](params_j, img_j)
    r_j = fn_j.stages["decoder_lrp"](params_j, feat_j, tok_j)
    maps_j = fn_j.stages["cnn_lrp"](params_j, img_j, r_j)
    # the f32 anchor: bench with LRPIC_BENCH_F32=1 on the bf16 run's tokens
    monkeypatch.setenv("LRPIC_BENCH_F32", "1")
    st32 = bench.build()[0].stages
    feat32, _ = st32["caption"](params_j, img_j)
    maps32 = st32["cnn_lrp"](params_j, img_j, st32["decoder_lrp"](params_j, feat32, tok_j))
    tok_j = np.asarray(tok_j)

    port_cfg = TConfig(**{k: v for k, v in OVERRIDES.items()
                          if k not in ("drop_rate", "image_size", "sentence_length")})
    fn_t, _ = pipeline.build(port_cfg, V, device="cpu", beam=K, T=T, storage_dtype=torch.bfloat16)
    params_t = params_from_jax(params_j, "cpu")
    img_t = torch.from_numpy(images)
    st = fn_t.stages
    feat_t, tok_t = st["caption"](params_t, img_t)
    assert feat_t.dtype == torch.float32
    # each conv output rounded to bf16 once per layer, 5 layers deep
    assert _dist(feat_t, feat_j) <= 2e-2
    np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    tok_e2e, maps_e2e = fn_t(params_t, images)
    np.testing.assert_array_equal(tok_e2e.numpy(), tok_j)
    assert maps_e2e.shape == (B, T, 32, 32, 3) and maps_e2e.dtype == torch.float32

    maps_t = st["cnn_lrp"](params_t, img_t, st["decoder_lrp"](params_t, feat_t,
                                                             torch.from_numpy(tok_j).long()))
    torch.testing.assert_close(maps_t, maps_e2e, rtol=0, atol=0)
    maps_j, maps32 = np.asarray(maps_j), np.asarray(maps32)
    for b in range(B):
        for t in range(T):
            _assert_anchored(maps_t[b, t], maps_j[b, t], maps32[b, t])
