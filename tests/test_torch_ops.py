"""PyTorch port: LRP primitives and conv/pool rules against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. Plain
f32 elementwise ops agree to the last ulp or two (rtol 1e-6); anything that
goes through a conv or matmul sums in another order (rtol/atol 1e-5 of the
values' unit scale).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.ops import lrp_conv as jconv  # noqa: E402
from lrp_imagecaptioning_tpu.ops import lrp_core as jcore  # noqa: E402
from lrp_imagecaptioning_torch.ops import lrp_conv as tconv  # noqa: E402
from lrp_imagecaptioning_torch.ops import lrp_core as tcore  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def test_sign_stabilizer_and_safe_divide_at_zero():
    z = np.array([0.0, -0.0, 1e-8, -1e-8, 2.0, -3.0], np.float32)
    a = np.array([1.0, 1.0, 1.0, 1.0, 4.0, 6.0], np.float32)
    # sign(0) = +1: both zeros move up by eps; exact equality, same f32 ops
    np.testing.assert_array_equal(tcore.sign_stabilizer(_t(z)).numpy(),
                                  np.asarray(jcore.sign_stabilizer(jnp.asarray(z))))
    assert tcore.sign_stabilizer(_t(z))[1].item() == pytest.approx(1e-7)
    # SafeDivide adds eps only where z == 0 exactly
    got = tcore.safe_divide(_t(a), _t(z)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcore.safe_divide(jnp.asarray(a), jnp.asarray(z))))
    assert got[0] == pytest.approx(1e7) and got[2] == pytest.approx(1e8)


def test_lrp_linear_and_identity_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    w = rng.normal(size=(12, 7)).astype(np.float32)
    z = x @ w
    r = rng.normal(size=(3, 5, 7)).astype(np.float32)
    got = tcore.lrp_linear(_t(r), _t(x), _t(z), _t(w)).numpy()
    ref = np.asarray(jcore.lrp_linear(jnp.asarray(r), jnp.asarray(x), jnp.asarray(z), jnp.asarray(w)))
    # matmul summation order differs; values are O(1..10)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    xi, zi, ri = x[..., :7], z, r
    got = tcore.lrp_identity(_t(ri), _t(xi), _t(zi)).numpy()
    ref = np.asarray(jcore.lrp_identity(jnp.asarray(ri), jnp.asarray(xi), jnp.asarray(zi)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_conv2d_and_input_vjp_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    k = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    s = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    np.testing.assert_allclose(tconv.conv2d(_t(x), _t(k)).numpy(),
                               np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(k))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tconv.conv2d_input_vjp(None, _t(k), _t(s)).numpy(),
                               np.asarray(jconv.conv2d_input_vjp(x.shape, jnp.asarray(k), jnp.asarray(s))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("input_nonneg,with_bias", [(False, True), (True, True), (False, False)])
def test_lrp_conv_alpha_beta_matches_jax(input_nonneg, with_bias):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    if input_nonneg:
        x = np.abs(x)
    k = rng.normal(size=(3, 3, 6, 8)).astype(np.float32)
    # signed bias: with input_nonneg z must take the FULL bias b+ + b-
    b = rng.normal(size=(8,)).astype(np.float32)
    r = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    got = tconv.lrp_conv_alpha_beta(_t(r), _t(x), _t(k), _t(b) if with_bias else None,
                                    input_nonneg=input_nonneg).numpy()
    # the JAX rule at alpha = 1, beta = 0: the port's only setting
    ref = np.asarray(jconv.lrp_conv_alpha_beta(jnp.asarray(r), jnp.asarray(x), jnp.asarray(k),
                                               jnp.asarray(b) if with_bias else None, 1.0, 0.0,
                                               input_nonneg=input_nonneg))
    # r/z amplifies conv rounding where z is small: compare against the map scale
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-4 * scale


def test_lrp_conv_alpha_beta_shared_input_broadcasts():
    """x with batch 1 against N relevances equals x tiled N times."""
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(size=(1, 6, 6, 4))).astype(np.float32)
    k = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    r = rng.normal(size=(3, 6, 6, 8)).astype(np.float32)
    for nonneg in (False, True):
        shared = tconv.lrp_conv_alpha_beta(_t(r), _t(x), _t(k), _t(b), input_nonneg=nonneg)
        tiled = tconv.lrp_conv_alpha_beta(_t(r), _t(np.repeat(x, 3, 0)), _t(k), _t(b),
                                          input_nonneg=nonneg).numpy()
        # the CPU conv sums a batch of 1 and a batch of 3 in different orders,
        # so the two differ in the last ulps; compare against the map's scale
        scale = np.abs(tiled).max()
        assert np.abs(shared.numpy() - tiled).max() <= 1e-6 * scale


def test_maxpool2d_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tconv.maxpool2d(_t(x)).numpy(),
                                  np.asarray(jconv.maxpool2d(jnp.asarray(x))))


def test_lrp_maxpool_wta_splits_ties_equally():
    rng = np.random.default_rng(6)
    # values on a coarse grid so many 2x2 windows hold exact ties
    x = rng.integers(0, 3, size=(2, 8, 8, 4)).astype(np.float32)
    x[0, :2, :2, 0] = 1.0  # one window fully tied: each of 4 entries gets r/4
    r = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    got = tconv.lrp_maxpool_wta(_t(r), _t(x)).numpy()
    ref = np.asarray(jconv.lrp_maxpool_wta(jnp.asarray(r), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[0, :2, :2, 0], np.full((2, 2), r[0, 0, 0, 0] / 4), rtol=1e-6)
    # relevance is conserved window by window
    np.testing.assert_allclose(got.reshape(2, 4, 2, 4, 2, 4).sum(axis=(2, 4)), r,
                               rtol=1e-5, atol=1e-6)
