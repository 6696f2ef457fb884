"""PyTorch port: the analyzer registry (``explain/analyzers.py``), DeepTaylor,
DeepLIFT, PatternNet / PatternAttribution (``explain/patterns.py``), the
perturbation analysis (``explain/perturbation.py``) and the wrappers,
against the JAX package, mirroring its ``tests/test_analyzers_registry.py``
one test for one, on the same numpy-seeded inputs and ``params_from_jax``
weights.

Every one of the 32 names runs through both registries on a walk with a
pool and two post-ReLU convs (``block2_conv1``): maps within 1e-4 of the
JAX map's scale in f32, and in f64 on both sides for the names that divide
by a z that can sit near 0 (``lrp.z``, ``lrp.epsilon`` at 1e-7, the
alpha2beta1 inhibitor, zB) and for DeepLIFT, whose f32 runs lie far from
f64 in both packages (``tests/test_torch_deep_methods.py``). ``random`` and
``smoothgrad`` take JAX's draws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.explain import analyzers as ja  # noqa: E402
from lrp_imagecaptioning_tpu.explain import patterns as jpat  # noqa: E402
from lrp_imagecaptioning_tpu.explain import perturbation as jpert  # noqa: E402
from lrp_imagecaptioning_tpu.models import vgg as jvgg  # noqa: E402
from lrp_imagecaptioning_torch.explain import analyzers as ta  # noqa: E402
from lrp_imagecaptioning_torch.explain import cnn_deeplift as tdl  # noqa: E402
from lrp_imagecaptioning_torch.explain import cnn_lrp as tcnn  # noqa: E402
from lrp_imagecaptioning_torch.explain import patterns as tpat  # noqa: E402
from lrp_imagecaptioning_torch.explain.perturbation import (  # noqa: E402
    Perturbation,
    PerturbationAnalysis,
)
from lrp_imagecaptioning_torch.models.vgg import vgg_apply  # noqa: E402
from lrp_imagecaptioning_torch.ops.lrp_conv import conv2d  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax, tree_to  # noqa: E402

torch.set_num_threads(2)

MAP_RTOL = 1e-4
F64_RTOL = 1e-7
UNTIL = "block1_conv2"
UNTIL_POOL = "block2_conv1"
LOW, HIGH = -150.0, 150.0          # deep_taylor.bounded: the images' value range

REFERENCE_REGISTRY_NAMES = [
    # innvestigate/analyzer/__init__.py:35-85, verbatim
    "input", "random",
    "gradient", "gradient.baseline", "input_t_gradient", "deconvnet",
    "guided_backprop", "integrated_gradients", "smoothgrad",
    "lrp.z", "lrp.z_IB", "lrp.epsilon", "lrp.epsilon_IB",
    "lrp.w_square", "lrp.flat", "lrp.alpha_beta",
    "lrp.alpha_2_beta_1", "lrp.alpha_2_beta_1_IB",
    "lrp.alpha_1_beta_0", "lrp.alpha_1_beta_0_IB",
    "lrp.z_plus", "lrp.z_plus_fast",
    "lrp.sequential_preset_a", "lrp.sequential_preset_b",
    "lrp.sequential_preset_a_flat", "lrp.sequential_preset_b_flat",
    "deep_taylor", "deep_taylor.bounded",
    "deep_lift", "deep_lift.wrapper",
    "pattern.net", "pattern.attribution",
]
F64_NAMES = {"lrp.z", "lrp.z_IB", "lrp.epsilon", "lrp.epsilon_IB", "lrp.alpha_beta",
             "lrp.alpha_2_beta_1", "lrp.alpha_2_beta_1_IB", "lrp.sequential_preset_b",
             "lrp.sequential_preset_b_flat", "deep_taylor.bounded", "deep_lift",
             "deep_lift.wrapper"}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    return 0.0 if scale == 0 else float(np.abs(got - ref).max() / scale)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _vgg(until=UNTIL, seed=0):
    """JAX VGG params with biases drawn (the init's are zero) and their port."""
    pj = jvgg.init_vgg_params(jax.random.PRNGKey(seed), "vgg16", until)
    rng = np.random.default_rng(200 + seed)
    for p in pj.values():
        p["bias"] = jnp.asarray(rng.normal(size=p["bias"].shape).astype(np.float32) * 0.05)
    return pj, params_from_jax(pj, "cpu")


def _setup(rng, B=1, size=16, until=UNTIL):
    pj, pt = _vgg(until)
    image = (rng.normal(size=(B, size, size, 3)) * 40).astype(np.float32)
    g, ch = (size, 64) if until == UNTIL else (size // 2, 128)
    seed = rng.normal(size=(B, g, g, ch)).astype(np.float32)
    return pj, pt, image, seed


# ---------------------------------------------------------------- registry


def test_registry_names_equal_jax():
    assert ta.analyzer_names() == ja.analyzer_names() == sorted(REFERENCE_REGISTRY_NAMES)


def test_registry_unknown_name_raises(rng):
    _, pt, _, _ = _setup(rng)
    with pytest.raises(KeyError, match="lrp.sequential_preset_a"):
        ta.create_analyzer("no.such.analyzer", pt)


def _name_kwargs(name, pj, image, f64):
    """(JAX kwargs, port kwargs) of ``name`` beyond until / arch."""
    if name == "deep_taylor.bounded":
        return dict(low=LOW, high=HIGH), dict(low=LOW, high=HIGH)
    if name == "lrp.alpha_beta":
        return dict(alpha=2.0, beta=1.0), dict(alpha=2.0, beta=1.0)
    if name == "smoothgrad":
        key = jax.random.PRNGKey(1)
        noise = np.stack([np.asarray(jax.random.normal(k, image.shape))
                          for k in jax.random.split(key, 2)], axis=1)
        return dict(rng_key=key, n=2), dict(noise=_t(noise), n=2)
    if name == "random":
        key = jax.random.PRNGKey(2)
        return dict(rng_key=key), dict(noise=_t(np.asarray(jax.random.normal(key, image.shape))))
    if name.startswith("pattern."):
        pats = jpat.compute_vgg_patterns(pj, [image], "relu", "vgg16", UNTIL_POOL)
        return dict(patterns=pats), dict(patterns=params_from_jax(pats, "cpu"))
    return {}, {}


@pytest.mark.parametrize("name", REFERENCE_REGISTRY_NAMES)
def test_registry_matches_jax(rng, name):
    """The dryrun invariant (dryrun.py:103-116): input-shaped and finite, and
    each name's map the JAX package's on the same inputs."""
    pj, pt, image, seed = _setup(rng, B=2, until=UNTIL_POOL)
    f64 = name in F64_NAMES
    jkw, tkw = _name_kwargs(name, pj, image, f64)
    if f64:
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), pj)
            ref = np.asarray(ja.create_analyzer(name, p64, arch="vgg16", until=UNTIL_POOL, **jkw)(
                jnp.asarray(image, jnp.float64), jnp.asarray(seed, jnp.float64)))
        got = ta.create_analyzer(name, tree_to(pt, dtype=torch.float64), until=UNTIL_POOL, **tkw)(
            _t(image, torch.float64), _t(seed, torch.float64))
        assert ref.dtype == np.float64 and got.dtype == torch.float64
    else:
        ref = np.asarray(ja.create_analyzer(name, pj, arch="vgg16", until=UNTIL_POOL, **jkw)(
            jnp.asarray(image), jnp.asarray(seed)))
        got = ta.create_analyzer(name, pt, until=UNTIL_POOL, **tkw)(_t(image), _t(seed))
    got = got.detach().numpy()
    assert got.shape == image.shape and np.isfinite(got).all()
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= (F64_RTOL if f64 else MAP_RTOL)


def test_registry_preset_a_matches_direct_call(rng):
    _, pt, image, seed = _setup(rng)
    via_registry = ta.create_analyzer("lrp.sequential_preset_a", pt, until=UNTIL)(
        _t(image), _t(seed))
    direct = tcnn.vgg_lrp_preset_a(pt, _t(image), _t(seed), until=UNTIL)
    np.testing.assert_array_equal(via_registry.numpy(), direct.numpy())


def test_random_and_smoothgrad_draw_from_the_generator(rng):
    """Without ``noise`` the draws come from the generator: one seed, one map."""
    _, pt, image, seed = _setup(rng, size=8)
    for name, kw in (("random", {}), ("smoothgrad", {"n": 2})):
        a, b = (ta.create_analyzer(name, pt, until=UNTIL, **kw)(
            _t(image), _t(seed), generator=torch.Generator().manual_seed(5)) for _ in range(2))
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert a.shape == image.shape


# ---------------------------------------------------------------- deep taylor


def test_deep_taylor_equals_preset_a_for_positive_seed(rng):
    _, pt, image, seed = _setup(rng)
    pos = _t(np.abs(seed))
    dt = tcnn.vgg_deep_taylor(pt, _t(image), pos, until=UNTIL)
    pa = tcnn.vgg_lrp_preset_a(pt, _t(image), pos, until=UNTIL)
    np.testing.assert_array_equal(dt.numpy(), pa.numpy())


def test_deep_taylor_clamps_negative_seed(rng):
    _, pt, image, seed = _setup(rng)
    out = tcnn.vgg_deep_taylor(pt, _t(image), _t(-np.abs(seed)), until=UNTIL)
    assert float(out.abs().max()) == 0.0


def test_deep_taylor_bounded_differs_on_input_layer(rng):
    _, pt, image, seed = _setup(rng)
    pos = _t(np.abs(seed))
    plain = ta.create_analyzer("deep_taylor", pt, until=UNTIL)(_t(image), pos)
    bounded = ta.create_analyzer("deep_taylor.bounded", pt, low=LOW, high=HIGH,
                                 until=UNTIL)(_t(image), pos)
    assert not np.allclose(plain.numpy(), bounded.numpy())


# ---------------------------------------------------------------- deeplift


def test_deeplift_completeness_single_linear_layer(rng):
    """One bias-free conv unit against a zero reference: the rescale rule
    hands back exactly the output difference, sum(attribution) == sum(seed)."""
    pj = jvgg.init_vgg_params(jax.random.PRNGKey(0), "vgg16", "block1_conv1")
    pt = params_from_jax(pj, "cpu")
    image = _t(rng.normal(size=(1, 8, 8, 3)).astype(np.float32))
    seed = vgg_apply(pt, image, until="block1_conv1")
    attrib = tdl.vgg_deeplift(pt, image, seed, until="block1_conv1")
    np.testing.assert_allclose(float(attrib.sum()), float(seed.sum()), rtol=1e-4)


def test_deeplift_standalone_seed_is_output_difference(rng):
    _, pt, image, _ = _setup(rng)
    via_standalone = tdl.vgg_deeplift_standalone(pt, _t(image), until=UNTIL)
    out = vgg_apply(pt, _t(image), until=UNTIL)
    ref = vgg_apply(pt, torch.zeros(image.shape), until=UNTIL)
    via_seed = tdl.vgg_deeplift(pt, _t(image), out - ref, until=UNTIL)
    np.testing.assert_allclose(via_standalone.numpy(), via_seed.numpy(), rtol=1e-5, atol=1e-6)


def test_deeplift_exact_branch_runs(rng):
    _, pt, image, seed = _setup(rng)
    out = tdl.vgg_deeplift(pt, _t(image), _t(seed), until=UNTIL, approximate_gradient=False)
    assert out.shape == image.shape and torch.isfinite(out).all()


# ---------------------------------------------------------------- patterns


def test_conv_patches_match_conv_and_jax(rng):
    x = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    patches = tpat._conv_patches_3x3(_t(x))
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jpat._conv_patches_3x3(
        jnp.asarray(x))))
    np.testing.assert_allclose((patches.reshape(-1, 27) @ _t(k).reshape(27, 5)).numpy(),
                               conv2d(_t(x), _t(k)).reshape(-1, 5).numpy(), rtol=1e-4, atol=1e-5)


def test_linear_pattern_recovers_signal_direction():
    """For x = a y + noise with noise orthogonal to w, the port's pattern
    computation recovers the direction a (tools/pattern.py:277-305), from
    the statistics of one 3x3x3 -> 1 conv."""
    rng = np.random.default_rng(7)
    d, n = 27, 20000
    w = rng.normal(size=(d, 1))
    a = rng.normal(size=(d, 1))
    a = a / (w.T @ a)
    y = rng.normal(size=(n, 1))
    noise = rng.normal(size=(n, d))
    noise -= (noise @ w) @ w.T / float((w.T @ w)[0, 0])
    X = y @ a.T + noise
    Y = X @ w
    stats = {"block1_conv1": {"sum_x": _t(X.sum(0)[:, None]), "sum_xy": _t((X * Y).sum(0)[:, None]),
                              "cnt": _t([float(n)]), "sum_y": _t(Y.sum(0)),
                              "cnt_all": _t(float(n))}}
    params = {"block1_conv1": {"kernel": _t(w.reshape(3, 3, 3, 1)), "bias": torch.zeros(1)}}
    A = tpat.compute_patterns(stats, params, until="block1_conv1")["block1_conv1"]
    np.testing.assert_allclose(A.numpy().reshape(-1), a[:, 0], atol=0.05)


def test_pattern_stats_streaming_equals_one_shot(rng):
    pj, pt, image, _ = _setup(rng, B=4, until=UNTIL_POOL)
    one = tpat.compute_vgg_patterns(pt, [image], "linear", until=UNTIL_POOL)
    two = tpat.compute_vgg_patterns(pt, [image[:2], image[2:]], "linear", until=UNTIL_POOL)
    for name in one:
        np.testing.assert_allclose(one[name].numpy(), two[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * float(one[name].abs().max()))


@pytest.mark.parametrize("pattern_type", tpat.PATTERN_TYPES)
def test_patterns_match_jax_f64(rng, pattern_type):
    """The statistics and the patterns of each type, in f64 on both sides (a
    pattern divides by diag(W^T cov), which f32 sums can leave near 0)."""
    pj, pt, image, _ = _setup(rng, B=2, until=UNTIL_POOL)
    batches = [image[:1], image[1:]]
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), pj)
        ref = jpat.compute_vgg_patterns(p64, [b.astype(np.float64) for b in batches],
                                        pattern_type, "vgg16", UNTIL_POOL)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    got = tpat.compute_vgg_patterns(tree_to(pt, dtype=torch.float64), batches, pattern_type,
                                    until=UNTIL_POOL)
    assert set(got) == set(ref) == {"block1_conv1", "block1_conv2", "block2_conv1"}
    for name in ref:
        assert got[name].dtype == torch.float64 and ref[name].dtype == np.float64
        assert _rel(got[name].numpy(), ref[name]) <= F64_RTOL, name


def test_pattern_types_differ(rng):
    _, pt, image, _ = _setup(rng, B=2)
    lin = tpat.compute_vgg_patterns(pt, [image], "linear", until=UNTIL)
    rel = tpat.compute_vgg_patterns(pt, [image], "relu", until=UNTIL)
    assert not np.allclose(lin["block1_conv1"].numpy(), rel["block1_conv1"].numpy())
    with pytest.raises(ValueError):
        tpat.compute_vgg_patterns(pt, [image], "quadratic", until=UNTIL)


def test_patternnet_vs_attribution_differ_and_match_jax(rng):
    pj, pt, image, seed = _setup(rng)
    pats = jpat.compute_vgg_patterns(pj, [image], "relu", "vgg16", UNTIL)
    tp = params_from_jax(pats, "cpu")      # the patterns dict crosses as params do
    assert set(tp) == set(pats) and all(tp[k].shape == pats[k].shape for k in pats)
    net = tpat.vgg_patternnet(pt, tp, _t(image), _t(seed), until=UNTIL).numpy()
    att = tpat.vgg_pattern_attribution(pt, tp, _t(image), _t(seed), until=UNTIL).numpy()
    assert not np.allclose(net, att)
    assert _rel(net, jpat.vgg_patternnet(pj, pats, jnp.asarray(image), jnp.asarray(seed),
                                         "vgg16", UNTIL)) <= MAP_RTOL
    assert _rel(att, jpat.vgg_pattern_attribution(pj, pats, jnp.asarray(image),
                                                  jnp.asarray(seed), "vgg16", UNTIL)) <= MAP_RTOL


# ---------------------------------------------------------------- wrappers


def test_gaussian_smoother_zero_noise_and_jax_draws(rng):
    pj, pt, image, seed = _setup(rng)
    analyze = ta.create_analyzer("gradient", pt, until=UNTIL)
    smoothed = ta.gaussian_smoother(analyze, _t(image), _t(seed),
                                    torch.Generator().manual_seed(0), noise_scale=0.0, n=3)
    np.testing.assert_allclose(smoothed.numpy(), analyze(_t(image), _t(seed)).numpy(),
                               rtol=1e-5, atol=1e-6)
    # JAX's draws (one per split key) fed in: the JAX wrapper's map
    key = jax.random.PRNGKey(4)
    noise = np.stack([np.asarray(jax.random.normal(k, image.shape))
                      for k in jax.random.split(key, 3)])
    got = ta.gaussian_smoother(analyze, _t(image), _t(seed), noise_scale=2.0, n=3,
                               noise=_t(noise)).numpy()
    ref = ja.gaussian_smoother(ja.create_analyzer("gradient", pj, until=UNTIL),
                               jnp.asarray(image), jnp.asarray(seed), key, noise_scale=2.0, n=3)
    assert _rel(got, ref) <= MAP_RTOL


def test_path_integrator_matches_integrated_gradients(rng):
    """PathIntegrator(gradient) == IntegratedGradients, and the JAX wrapper
    over PresetA with a reference input."""
    pj, pt, image, seed = _setup(rng)
    analyze = ta.create_analyzer("gradient", pt, until=UNTIL)
    via_wrapper = ta.path_integrator(analyze, _t(image), _t(seed), steps=8)
    via_ig = ta.create_analyzer("integrated_gradients", pt, steps=8, until=UNTIL)(
        _t(image), _t(seed))
    np.testing.assert_allclose(via_wrapper.numpy(), via_ig.numpy(), rtol=1e-3,
                               atol=1e-4 * float(via_ig.abs().max()))
    got = ta.path_integrator(ta.create_analyzer("lrp.sequential_preset_a", pt, until=UNTIL),
                             _t(image), _t(seed), steps=3, reference_inputs=5.0).numpy()
    ref = ja.path_integrator(ja.create_analyzer("lrp.sequential_preset_a", pj, until=UNTIL),
                             jnp.asarray(image), jnp.asarray(seed), steps=3,
                             reference_inputs=5.0)
    assert _rel(got, ref) <= MAP_RTOL


@pytest.mark.parametrize("reduce", ["mean", "sum", "stack", "max"])
def test_augment_reduce_matches_jax(rng, reduce):
    pj, pt, image, seed = _setup(rng, size=8)
    got = ta.augment_reduce(ta.create_analyzer("input_t_gradient", pt, until=UNTIL), _t(image),
                            _t(seed), lambda im, i: im * (1.0 + i), 3,
                            (lambda m, d: m.amax(d)) if reduce == "max" else reduce).numpy()
    ref = ja.augment_reduce(ja.create_analyzer("input_t_gradient", pj, until=UNTIL),
                            jnp.asarray(image), jnp.asarray(seed), lambda im, i: im * (1.0 + i), 3,
                            (lambda m, d: m.max(d)) if reduce == "max" else reduce)
    assert _rel(got, ref) <= MAP_RTOL
    with pytest.raises(ValueError):
        ta.augment_reduce(lambda im, s: im, _t(image), _t(seed), lambda im, i: im, 2, "median")


# ---------------------------------------------------------------- perturbation


def test_region_ordering_matches_reference_semantics():
    agg = np.array([[[[3.0, 1.0], [2.0, 4.0]]]])
    ranks = Perturbation.compute_region_ordering(agg)
    assert ranks[0, 0, 1, 1] == 0 and ranks[0, 0, 0, 0] == 1
    assert ranks[0, 0, 1, 0] == 2 and ranks[0, 0, 0, 1] == 3
    np.testing.assert_array_equal(ranks, jpert.Perturbation.compute_region_ordering(agg))


def test_perturbation_zeros_hits_most_relevant_region():
    x = np.ones((1, 6, 6, 2), np.float32)
    analysis = np.zeros((1, 6, 6, 2), np.float32)
    analysis[0, 0:3, 3:6, :] = 5.0
    p = Perturbation("zeros", num_perturbed_regions=1, region_shape=(3, 3))
    out = p.perturbate_on_batch(x, analysis)
    assert np.all(out[0, 0:3, 3:6, :] == 0.0)
    assert np.all(out[0, 3:6, :, :] == 1.0) and np.all(out[0, 0:3, 0:3, :] == 1.0)


def test_perturbation_custom_function_and_padding():
    x = np.ones((1, 5, 7, 1), np.float32)
    analysis = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    p = Perturbation(lambda region: np.full_like(region, -9.0), num_perturbed_regions=2,
                     region_shape=(3, 3))
    out = p.perturbate_on_batch(x, analysis)
    assert out.shape == x.shape
    assert np.any(out == -9.0) and np.any(out == 1.0)
    with pytest.raises(ValueError):
        Perturbation("blur")


def test_perturbation_value_range_clips():
    x = np.full((1, 3, 3, 1), 2.0, np.float32)
    p = Perturbation("invert", num_perturbed_regions=1, region_shape=(3, 3),
                     value_range=(-1.0, 1.0))
    assert np.all(p.perturbate_on_batch(x, np.ones_like(x)) == -1.0)


@pytest.mark.parametrize("mode", ["zeros", "gaussian", "mean", "invert"])
def test_perturbation_matches_jax(mode):
    """Each built-in mode on padded regions, the gaussian one from the same
    numpy generator, equal to the JAX package's module."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 10, 13, 3)).astype(np.float32)
    analysis = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(num_perturbed_regions=3, region_shape=(4, 4))
    got = Perturbation(mode, rng=np.random.default_rng(1), **kw).perturbate_on_batch(x, analysis)
    ref = jpert.Perturbation(mode, rng=np.random.default_rng(1), **kw).perturbate_on_batch(
        x, analysis)
    np.testing.assert_array_equal(got, ref)


def test_perturbation_analysis_morf_curve():
    """Score = the pixels' sum, relevance = the input: occluding the highest
    regions first gives a falling curve of steps + 1 scores, the JAX
    module's."""
    rng = np.random.default_rng(3)
    x = np.abs(rng.normal(size=(4, 9, 9, 1))).astype(np.float32)
    kw = dict(analyze_fn=lambda img: img, score_fn=lambda img, y: float(np.sum(img)),
              batches=[(x, np.zeros(len(x)))], steps=3, regions_per_step=2)
    scores = PerturbationAnalysis(perturbation=Perturbation("zeros", region_shape=(3, 3)),
                                  **kw).compute_perturbation_analysis()
    assert len(scores) == 4
    assert all(a > b for a, b in zip(scores, scores[1:]))
    ref = jpert.PerturbationAnalysis(perturbation=jpert.Perturbation("zeros", region_shape=(3, 3)),
                                     **kw).compute_perturbation_analysis()
    assert scores == ref


def test_patch_correlate_matches_im2col_and_jax(rng):
    x = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    m = rng.normal(size=(2, 6, 6, 5)).astype(np.float32)
    via_patches = tpat._conv_patches_3x3(_t(x)).reshape(-1, 27).T @ _t(m).reshape(-1, 5)
    via_corr = tpat._patch_correlate(_t(x), _t(m))
    np.testing.assert_allclose(via_corr.numpy(), via_patches.numpy(), rtol=1e-4, atol=1e-5)
    assert _rel(via_corr.numpy(), jpat._patch_correlate(jnp.asarray(x), jnp.asarray(m))) \
        <= MAP_RTOL
