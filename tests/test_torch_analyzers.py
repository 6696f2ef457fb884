"""PyTorch port: the conv rules and the CNN LRP's research entry points
(``ops/lrp_conv.py``'s epsilon, flat, z+, zB and general alpha-beta rules,
``explain/cnn_lrp.py``'s presets and walks, the gradient family through the
analyzer registry) against the JAX package, mirroring the JAX package's
``tests/test_analyzers.py`` one test for one, on the same numpy-seeded
inputs and ``params_from_jax`` weights.

Tolerances. A map is held to 1e-4 of its scale (max |JAX|) in f32, as the
port's other LRP maps. Rules that divide by a z that can sit near 0 (the
epsilon rule at 1e-7, the alpha2beta1 inhibitor, zB) amplify last-ulp
differences of the sums without bound, so they are compared in f64 on both
sides (``jax.enable_x64``), as ``tests/test_torch_deep_methods.py`` does for
DeepLIFT. bf16 maps are held to an f32 anchor within 2x the JAX bf16 run's
distance from it (``tests/test_torch_bf16.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.evalx import words as jwords  # noqa: E402
from lrp_imagecaptioning_tpu.explain import analyzers as ja  # noqa: E402
from lrp_imagecaptioning_tpu.explain import cnn_lrp as jcnn  # noqa: E402
from lrp_imagecaptioning_tpu.models import vgg as jvgg  # noqa: E402
from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv  # noqa: E402
from lrp_imagecaptioning_torch.evalx import words as twords  # noqa: E402
from lrp_imagecaptioning_torch.explain import analyzers as ta  # noqa: E402
from lrp_imagecaptioning_torch.explain import cnn_lrp as tcnn  # noqa: E402
from lrp_imagecaptioning_torch.ops import lrp_conv as tconv  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_to  # noqa: E402

torch.set_num_threads(2)

MAP_RTOL = 1e-4
F64_RTOL = 1e-7    # f64 sums in two orders, divided by z near 0
BF16_RATIO = 2.0
UNTIL = "block1_conv2"     # the JAX tests' 2-conv stack: one post-ReLU conv
UNTIL_POOL = "block2_conv1"  # a pool and two post-ReLU convs on the walk


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    return 0.0 if scale == 0 else float(np.abs(got - ref).max() / scale)


def _vgg(until=UNTIL, seed=0):
    """JAX VGG params with biases drawn (the init's are zero) and their port."""
    pj = jvgg.init_vgg_params(jax.random.PRNGKey(seed), "vgg16", until)
    rng = np.random.default_rng(100 + seed)
    for p in pj.values():
        p["bias"] = jnp.asarray(rng.normal(size=p["bias"].shape).astype(np.float32) * 0.05)
    return pj, params_from_jax(pj, "cpu")


def _setup(rng, B=1, size=16, until=UNTIL):
    """The JAX tests' ``_setup``: params, image (B, size, size, 3), seed at the tap."""
    pj, pt = _vgg(until)
    image = (rng.normal(size=(B, size, size, 3)) * 40).astype(np.float32)
    g, ch = (size, 64) if until == UNTIL else (size // 2, 128)
    seed = rng.normal(size=(B, g, g, ch)).astype(np.float32)
    return pj, pt, image, seed


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _jax64(fn, *arrays, params=None):
    """``fn(params64, *arrays64)`` under x64 -> numpy f64."""
    with jax.enable_x64(True):
        args = [jnp.asarray(a, jnp.float64) for a in arrays]
        if params is not None:
            p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
            return np.asarray(fn(p64, *args))
        return np.asarray(fn(*args))


def _rule_inputs(rng, nonneg=False):
    x = rng.normal(size=(1, 8, 8, 2)).astype(np.float32)
    if nonneg:
        x = np.abs(x)
    k = rng.normal(size=(3, 3, 2, 3)).astype(np.float32)
    r = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    return x, k, r


def test_wsquare_input_independent_and_matches_jax(rng):
    x1 = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    x2 = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    r = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    out1 = tconv.lrp_conv_wsquare(_t(r), _t(x1), _t(k)).numpy()
    out2 = tconv.lrp_conv_wsquare(_t(r), _t(x2), _t(k)).numpy()
    np.testing.assert_array_equal(out1, out2)
    ref = jconv.lrp_conv_wsquare(jnp.asarray(r), jnp.asarray(x1), jnp.asarray(k))
    assert _rel(out1, ref) <= MAP_RTOL


def test_flat_conserves_interior_and_matches_jax(rng):
    """The flat rule spreads relevance evenly; the total is conserved."""
    x = rng.normal(size=(1, 8, 8, 2)).astype(np.float32)
    k = rng.normal(size=(3, 3, 2, 3)).astype(np.float32)
    r = np.abs(rng.normal(size=(1, 8, 8, 3)).astype(np.float32))
    out = tconv.lrp_conv_flat(_t(r), _t(x), _t(k)).numpy()
    np.testing.assert_allclose(out.sum(), r.sum(), rtol=1e-4)
    assert _rel(out, jconv.lrp_conv_flat(jnp.asarray(r), jnp.asarray(x), jnp.asarray(k))) \
        <= MAP_RTOL


def test_zplus_equals_alpha1beta0_and_matches_jax(rng):
    x, k, r = _rule_inputs(rng)
    zplus = tconv.lrp_conv_zplus(_t(r), _t(x), _t(k)).numpy()
    np.testing.assert_array_equal(
        zplus, tconv.lrp_conv_alpha_beta(_t(r), _t(x), _t(k), None, alpha=1.0, beta=0.0).numpy())
    assert _rel(zplus, jconv.lrp_conv_zplus(jnp.asarray(r), jnp.asarray(x), jnp.asarray(k))) \
        <= MAP_RTOL


def test_bounded_conserves_and_matches_jax_f64(rng):
    """zB conserves relevance (sum over the inputs == sum of r), and equals
    the JAX rule in f64."""
    x = rng.uniform(-1, 1, size=(1, 8, 8, 2)).astype(np.float32)
    k = rng.normal(size=(3, 3, 2, 3)).astype(np.float32)
    r = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    out = tconv.lrp_conv_bounded(_t(r), _t(x), _t(k), low=-1.0, high=1.0).numpy()
    np.testing.assert_allclose(out.sum(), r.sum(), rtol=5e-2, atol=1e-2)
    got = tconv.lrp_conv_bounded(_t(r, torch.float64), _t(x, torch.float64),
                                 _t(k, torch.float64), low=-1.0, high=1.0).numpy()
    ref = _jax64(lambda r_, x_, k_: jconv.lrp_conv_bounded(r_, x_, k_, low=-1.0, high=1.0),
                 r, x, k)
    assert _rel(got, ref) <= F64_RTOL


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("eps", [1e-7, 0.01])
def test_epsilon_rule_matches_jax_f64(rng, bias, eps):
    x, k, r = _rule_inputs(rng)
    b = rng.normal(size=(3,)).astype(np.float32) if bias else None
    t64 = lambda a: None if a is None else _t(a, torch.float64)  # noqa: E731
    got = tconv.lrp_conv_epsilon(t64(r), t64(x), t64(k), t64(b), eps=eps).numpy()
    ref = _jax64(lambda *a: jconv.lrp_conv_epsilon(a[0], a[1], a[2], a[3] if bias else None,
                                                  eps=eps), r, x, k, b if bias else 0.0)
    assert _rel(got, ref) <= F64_RTOL


@pytest.mark.parametrize("alpha,beta,nonneg,bias", [(2.0, 1.0, False, True),
                                                     (2.0, 1.0, True, False),
                                                     (3.0, 2.0, True, True),
                                                     (1.0, 0.0, False, False)])
def test_alpha_beta_general_matches_jax_f64(rng, alpha, beta, nonneg, bias):
    """The general AlphaBetaRule and a non-default SafeDivide factor."""
    x, k, r = _rule_inputs(rng, nonneg)
    b = rng.normal(size=(3,)).astype(np.float32)
    t64 = lambda a: _t(a, torch.float64)  # noqa: E731
    got = tconv.lrp_conv_alpha_beta(t64(r), t64(x), t64(k), t64(b) if bias else None, alpha, beta,
                                    factor=1e-3, input_nonneg=nonneg).numpy()
    ref = _jax64(lambda r_, x_, k_, b_: jconv.lrp_conv_alpha_beta(
        r_, x_, k_, b_ if bias else None, alpha=alpha, beta=beta, factor=1e-3,
        input_nonneg=nonneg), r, x, k, b)
    assert _rel(got, ref) <= F64_RTOL


def test_deconvnet_differs_from_gradient_and_matches_jax(rng):
    pj, pt, image, seed = _setup(rng)
    g = ta.create_analyzer("gradient", pt, until=UNTIL)(_t(image), _t(seed)).numpy()
    d = ta.create_analyzer("deconvnet", pt, until=UNTIL)(_t(image), _t(seed)).numpy()
    assert g.shape == d.shape == image.shape
    assert np.abs(g - d).max() > 1e-6
    ref = ja.create_analyzer("deconvnet", pj, until=UNTIL)(jnp.asarray(image), jnp.asarray(seed))
    assert _rel(d, ref) <= MAP_RTOL


def test_integrated_gradients_completeness_and_baseline(rng):
    """IG's defining property, sum(IG) ~= f(x) - f(baseline) with f the
    seed-contracted features, and the JAX map with a drawn baseline."""
    from lrp_imagecaptioning_torch.models.vgg import vgg_apply

    pj, pt, image, seed = _setup(rng, size=8)
    ig = ta.create_analyzer("integrated_gradients", pt, until=UNTIL, steps=64)(
        _t(image), _t(seed))

    def f(img):
        return float((vgg_apply(pt, img, until=UNTIL) * _t(seed)).sum())

    target = f(_t(image)) - f(torch.zeros(image.shape))
    np.testing.assert_allclose(float(ig.sum()), target, rtol=0.05, atol=0.5)
    base = (rng.normal(size=image.shape) * 10).astype(np.float32)
    got = ta.create_analyzer("integrated_gradients", pt, until=UNTIL, steps=4,
                             baseline=_t(base))(_t(image), _t(seed)).numpy()
    ref = ja.create_analyzer("integrated_gradients", pj, until=UNTIL, steps=4,
                             baseline=jnp.asarray(base))(jnp.asarray(image), jnp.asarray(seed))
    assert _rel(got, ref) <= MAP_RTOL


def test_smoothgrad_zero_noise_is_gradient_and_matches_jax_draws(rng):
    pj, pt, image, seed = _setup(rng, size=8)
    g = ta.create_analyzer("gradient", pt, until=UNTIL)(_t(image), _t(seed))
    sg = ta.create_analyzer("smoothgrad", pt, until=UNTIL, n=4, noise_scale=0.0,
                            generator=torch.Generator().manual_seed(0))(_t(image), _t(seed))
    np.testing.assert_allclose(sg.numpy(), g.numpy(), rtol=1e-5, atol=1e-5)
    key = jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(jax.random.normal(k, image.shape))
                      for k in jax.random.split(key, 3)], axis=1)
    got = ta.create_analyzer("smoothgrad", pt, until=UNTIL, n=3, noise=_t(noise))(
        _t(image), _t(seed)).numpy()
    ref = ja.create_analyzer("smoothgrad", pj, until=UNTIL, rng_key=key, n=3)(
        jnp.asarray(image), jnp.asarray(seed))
    assert _rel(got, ref) <= MAP_RTOL


def test_flat_input_presets_match_jax(rng):
    """PresetAFlat in f32; PresetBFlat (alpha2beta1) in f64."""
    pj, pt, image, seed = _setup(rng, size=8, until=UNTIL_POOL)
    a = tcnn.vgg_lrp_preset_a_flat(pt, _t(image), _t(seed), until=UNTIL_POOL).numpy()
    ref_a = jcnn.vgg_lrp_preset_a_flat(pj, jnp.asarray(image), jnp.asarray(seed), "vgg16",
                                       UNTIL_POOL)
    assert a.shape == image.shape and _rel(a, ref_a) <= MAP_RTOL
    b = tcnn.vgg_lrp_preset_b_flat(tree_to(pt, dtype=torch.float64), _t(image, torch.float64),
                                   _t(seed, torch.float64), until=UNTIL_POOL).numpy()
    ref_b = _jax64(lambda p, x, s: jcnn.vgg_lrp_preset_b_flat(p, x, s, "vgg16", UNTIL_POOL),
                   image, seed, params=pj)
    assert _rel(b, ref_b) <= F64_RTOL


def test_preset_a_bf16_modes_close_to_f32_as_jax(rng):
    """compute_dtype (bf16 convs over f32 storage) and storage_dtype (bf16
    storage): each within 2x the JAX run's distance from the f32 map."""
    pj, pt, _, _ = _setup(rng)
    image = rng.normal(size=(1, 16, 16, 3)).astype(np.float32) * 40
    seeds = rng.normal(size=(3, 16, 16, 64)).astype(np.float32)
    f32 = np.asarray(jcnn.vgg_lrp_preset_a_wordbatched(pj, jnp.asarray(image),
                                                       jnp.asarray(seeds), "vgg16", UNTIL))
    for kw, tkw in (({"compute_dtype": jnp.bfloat16}, {"compute_dtype": torch.bfloat16}),
                    ({"storage_dtype": jnp.bfloat16}, {"storage_dtype": torch.bfloat16})):
        ref = np.asarray(jcnn.vgg_lrp_preset_a_wordbatched(
            pj, jnp.asarray(image), jnp.asarray(seeds), "vgg16", UNTIL, **kw))
        got = tcnn.vgg_lrp_preset_a_wordbatched(pt, _t(image), _t(seeds), until=UNTIL, **tkw)
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), f32) <= max(BF16_RATIO * _rel(ref, f32), 1e-3), kw
        assert _rel(got.numpy(), f32) < 0.05


def test_preset_a_debug_stats_match_jax(rng):
    pj, pt, image, seed = _setup(rng, size=8, until=UNTIL_POOL)
    rel, stats = tcnn.vgg_lrp_preset_a_debug(pt, _t(image), _t(seed), until=UNTIL_POOL)
    plain = tcnn.vgg_lrp_preset_a(pt, _t(image), _t(seed), until=UNTIL_POOL)
    np.testing.assert_array_equal(rel.numpy(), plain.numpy())
    _, ref = jcnn.vgg_lrp_preset_a_debug(pj, jnp.asarray(image), jnp.asarray(seed), "vgg16",
                                         UNTIL_POOL)
    assert list(stats) == list(ref) == ["block2_conv1", "block1_pool", "block1_conv2",
                                        "block1_conv1"]
    for name, s in stats.items():
        assert int(s["nonfinite_count"]) == 0 == int(ref[name]["nonfinite_count"])
        assert float(s["min"]) <= float(s["max"])
        scale = max(abs(float(ref[name]["min"])), abs(float(ref[name]["max"])))
        for key in ("min", "max"):
            assert abs(float(s[key]) - float(ref[name][key])) <= MAP_RTOL * scale, (name, key)


def test_pool_heatmap_to_grid_matches_jax():
    hp = np.zeros((224, 224), np.float32)
    hp[0, 0] = 5.0
    hp[100, 100] = 3.0
    for pooling in ("max", "avg"):
        out = twords.pool_heatmap_to_grid(hp, grid=14, pooling=pooling)
        np.testing.assert_array_equal(out, jwords.pool_heatmap_to_grid(hp, 14, pooling))
    assert twords.pool_heatmap_to_grid(hp, 14, "max")[6, 6] == 3.0


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2.0, 1.0)])
def test_alpha_beta_nonneg_flag_exact(rng, alpha, beta):
    """input_nonneg=True is bit for bit the full rule on x >= 0 (the x- convs
    it elides are exactly zero), and the K3 route (``conv_rule``; its plain
    versions on the CPU) holds to the JAX rule."""
    x = np.abs(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    k = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    r = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    kw = dict(alpha=alpha, beta=beta)
    full = tconv.lrp_conv_alpha_beta(_t(r), _t(x), _t(k), _t(b), input_nonneg=False, **kw)
    fast = tconv.lrp_conv_alpha_beta(_t(r), _t(x), _t(k), _t(b), input_nonneg=True, **kw)
    np.testing.assert_array_equal(full.numpy(), fast.numpy())
    # no bias: z sums terms of one sign, so f32 holds to f64 closely
    routed = tcnn.conv_rule(_t(r), _t(x), _t(k), None, **kw).numpy()
    ref = _jax64(lambda r_, x_, k_: jconv.lrp_conv_alpha_beta(r_, x_, k_, None, input_nonneg=True,
                                                             **kw), r, x, k)
    assert _rel(routed, ref) <= MAP_RTOL


def test_preset_a_wordbatched_fused_matches_direct_and_jax(rng):
    """The m/w factorised walk equals the direct rule, without and with a
    pool on the walk, and the JAX package's fused walk."""
    for until in (UNTIL, UNTIL_POOL):
        pj, pt = _vgg(until)
        image = (rng.normal(size=(1, 16, 16, 3)) * 40).astype(np.float32)
        g, ch = (16, 64) if until == UNTIL else (8, 128)
        seeds = rng.normal(size=(3, g, g, ch)).astype(np.float32)
        direct = tcnn.vgg_lrp_preset_a_wordbatched(pt, _t(image), _t(seeds), until=until).numpy()
        fused = tcnn.vgg_lrp_preset_a_wordbatched_fused(pt, _t(image), _t(seeds), "vgg16",
                                                        until).numpy()
        np.testing.assert_allclose(fused, direct, rtol=2e-4, atol=1e-6 * np.abs(direct).max(),
                                   err_msg=until)
        ref = jcnn.vgg_lrp_preset_a_wordbatched_fused(pj, jnp.asarray(image), jnp.asarray(seeds),
                                                      "vgg16", until)
        assert _rel(fused, ref) <= MAP_RTOL, until


def test_preset_a_wordbatched_matches_jax_lane_packed_or_not(rng):
    """The port has no lane packing: its word-batched walk equals the JAX
    package's with ``lane_pack`` on and off, at W = 5 and W = 1."""
    pj, pt = _vgg(UNTIL_POOL)
    image = (rng.normal(size=(1, 16, 16, 3)) * 40).astype(np.float32)
    for W in (5, 1):
        seeds = rng.normal(size=(W, 8, 8, 128)).astype(np.float32)
        got = tcnn.vgg_lrp_preset_a_wordbatched(pt, _t(image), _t(seeds), until=UNTIL_POOL).numpy()
        for lane_pack in (True, False):
            ref = jcnn.vgg_lrp_preset_a_wordbatched(pj, jnp.asarray(image), jnp.asarray(seeds),
                                                    "vgg16", UNTIL_POOL, lane_pack=lane_pack)
            assert got.shape == (W, 16, 16, 3)
            assert _rel(got, ref) <= MAP_RTOL, (W, lane_pack)


def test_preset_a_imgword_batched_matches_jax(rng):
    """2 images x 3 words: f32 against JAX's imgword walk, bf16 storage and
    bf16 compute against the f32 map as the JAX runs lie from it."""
    pj, pt = _vgg(UNTIL_POOL)
    imgs = (rng.normal(size=(2, 16, 16, 3)) * 40).astype(np.float32)
    seeds = rng.normal(size=(2, 3, 8, 8, 128)).astype(np.float32)
    ref = np.asarray(jcnn.vgg_lrp_preset_a_imgword_batched(pj, jnp.asarray(imgs),
                                                           jnp.asarray(seeds), "vgg16", UNTIL_POOL))
    got = tcnn.vgg_lrp_preset_a_imgword_batched(pt, _t(imgs), _t(seeds), until=UNTIL_POOL).numpy()
    assert got.shape == (2, 3, 16, 16, 3) and _rel(got, ref) <= MAP_RTOL
    per_image = np.stack([tcnn.vgg_lrp_preset_a_wordbatched(pt, _t(imgs[b:b + 1]), _t(seeds[b]),
                                                            until=UNTIL_POOL).numpy()
                          for b in range(2)])
    np.testing.assert_array_equal(got, per_image)
    for kw, tkw in (({"storage_dtype": jnp.bfloat16}, {"storage_dtype": torch.bfloat16}),
                    ({"compute_dtype": jnp.bfloat16}, {"compute_dtype": torch.bfloat16})):
        jb = np.asarray(jcnn.vgg_lrp_preset_a_imgword_batched(
            pj, jnp.asarray(imgs), jnp.asarray(seeds), "vgg16", UNTIL_POOL, **kw))
        tb = tcnn.vgg_lrp_preset_a_imgword_batched(pt, _t(imgs), _t(seeds), until=UNTIL_POOL, **tkw)
        assert tb.dtype == torch.float32
        assert _rel(tb.numpy(), ref) <= max(BF16_RATIO * _rel(jb, ref), 1e-3), kw


def test_preset_b_and_epsilon_walks_match_jax_f64(rng):
    """PresetB (alpha2beta1 on every conv) and LRPEpsilon at its default
    eps = 0.01, with and without the bias, in f64."""
    pj, pt, image, seed = _setup(rng, size=8, until=UNTIL_POOL)
    p64 = tree_to(pt, dtype=torch.float64)
    x64, s64 = _t(image, torch.float64), _t(seed, torch.float64)
    got = tcnn.vgg_lrp_preset_b(p64, x64, s64, until=UNTIL_POOL).numpy()
    ref = _jax64(lambda p, x, s: jcnn.vgg_lrp_preset_b(p, x, s, "vgg16", UNTIL_POOL),
                 image, seed, params=pj)
    assert _rel(got, ref) <= F64_RTOL
    for bias in (True, False):
        got = tcnn.vgg_lrp_epsilon(p64, x64, s64, until=UNTIL_POOL, bias=bias).numpy()
        ref = _jax64(lambda p, x, s: jcnn.vgg_lrp_epsilon(p, x, s, "vgg16", UNTIL_POOL,
                                                          bias=bias), image, seed, params=pj)
        assert _rel(got, ref) <= F64_RTOL, bias
