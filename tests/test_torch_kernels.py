"""PyTorch port: the kernels' plain versions against the JAX Pallas kernels
run in interpret mode (as the JAX package's own tests run them on the CPU;
the bf16 rule's, ``lrp_a1b0_fused``, are in test_torch_bf16.py), and, on a
machine with a card, each CUDA kernel against its plain version (class
``TestOnCard``, marked ``cuda``; it skips here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lrp_imagecaptioning_torch.ops import kernels  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card tests also run on a
    machine without JAX (``pytest --noconftest -m cuda``)."""
    jnp = pytest.importorskip("jax.numpy")
    from lrp_imagecaptioning_tpu.ops import pallas_conv_lrp, pallas_kernels

    class NS:
        pass

    ns = NS()
    ns.jnp = jnp
    ns.lrp_linear_pallas = pallas_kernels.lrp_linear_pallas
    ns.lstm_gates_pallas = pallas_kernels.lstm_gates_pallas
    ns.conv3x3_fused = pallas_conv_lrp.conv3x3_fused
    ns.lrp_conv_a1b0_pallas = pallas_conv_lrp.lrp_conv_a1b0_pallas
    return ns


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _rel_err(got, ref):
    """max |got - ref| over the map's scale: the divides by stab(z) amplify
    last-ulp differences, so LRP maps are compared relative to their scale."""
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _linear_inputs(rng, lead, din, dout):
    x = rng.normal(size=(*lead, din)).astype(np.float32)
    w = rng.normal(size=(din, dout)).astype(np.float32)
    z = x @ w
    r = rng.normal(size=(*lead, dout)).astype(np.float32)
    return r, x, z, w


def _conv_inputs(rng, n, h, w, cin, cout):
    x = np.abs(rng.normal(size=(n, h, w, cin))).astype(np.float32)
    k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1
    b = rng.normal(size=(cout,)).astype(np.float32) * 0.1
    r = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    return x, k, b, r


def test_lrp_linear_plain_matches_pallas_nd_ragged(jx):
    jnp, lrp_linear_pallas = jx.jnp, jx.lrp_linear_pallas
    rng = np.random.default_rng(10)
    # ND leading dims (2, 3, 5) flatten to M = 30; Dout = 37 is no tile multiple
    r, x, z, w = _linear_inputs(rng, (2, 3, 5), 24, 37)
    ref = np.asarray(lrp_linear_pallas(jnp.asarray(r), jnp.asarray(x), jnp.asarray(z), jnp.asarray(w)))
    launches = kernels.lrp_linear.launches
    got = kernels.lrp_linear(_t(r), _t(x), _t(z), _t(w)).numpy()
    assert got.shape == (2, 3, 5, 24)
    assert kernels.lrp_linear.launches == launches  # a CPU tensor launches nothing
    assert _rel_err(got, ref) < 1e-5


def test_lstm_gates_plain_matches_pallas(jx):
    jnp, lstm_gates_pallas = jx.jnp, jx.lstm_gates_pallas
    rng = np.random.default_rng(11)
    z = rng.normal(size=(6, 4 * 32)).astype(np.float32) * 2
    c = rng.normal(size=(6, 32)).astype(np.float32)
    hj, cj = lstm_gates_pallas(jnp.asarray(z), jnp.asarray(c))
    ht, ct = kernels.lstm_gates(_t(z), _t(c))
    # elementwise transcendentals: a few ulp apart between XLA and ATen
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cin", [64, 128])
@pytest.mark.parametrize("mode", ["divide", "multiply"])
def test_conv3x3_fused_plain_matches_pallas(jx, mode, cin):
    jnp, j_conv3x3_fused = jx.jnp, jx.conv3x3_fused
    rng = np.random.default_rng(12 + cin)
    x, k, b, r = _conv_inputs(rng, 2, 8, 8, cin, 16)
    bias = b if mode == "divide" else None
    ref = np.asarray(j_conv3x3_fused(jnp.asarray(x), jnp.asarray(r), jnp.asarray(k),
                                     None if bias is None else jnp.asarray(bias),
                                     mode=mode, interpret=True))
    got = kernels.conv3x3_fused(_t(x), _t(r), _t(k), None if bias is None else _t(bias),
                                mode=mode).numpy()
    if mode == "divide":
        # quotient by z: well-conditioned only where |z| is not tiny
        z = np.asarray(r) / ref
        ok = np.abs(z) > 1e-2
        assert ok.mean() > 0.9
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-4, atol=1e-5)
    else:
        assert _rel_err(got, ref) < 1e-5


def test_lrp_conv_a1b0_matches_pallas(jx):
    jnp, lrp_conv_a1b0_pallas = jx.jnp, jx.lrp_conv_a1b0_pallas
    rng = np.random.default_rng(13)
    x, k, b, r = _conv_inputs(rng, 3, 8, 8, 64, 16)
    ref = np.asarray(lrp_conv_a1b0_pallas(jnp.asarray(r), jnp.asarray(x), jnp.asarray(k),
                                          jnp.asarray(b), interpret=True))
    got = kernels.lrp_conv_a1b0(_t(r), _t(x), _t(k), _t(b)).numpy()
    assert _rel_err(got, ref) < 1e-4
    # the port's word-batched form: x with batch 1 shared by 3 relevances
    shared = kernels.lrp_conv_a1b0(_t(r), _t(x[:1]), _t(k), _t(b)).numpy()
    tiled = np.asarray(lrp_conv_a1b0_pallas(jnp.asarray(r), jnp.asarray(np.repeat(x[:1], 3, 0)),
                                            jnp.asarray(k), jnp.asarray(b), interpret=True))
    assert _rel_err(shared, tiled) < 1e-4


def test_conv3x3_fused_rejects_bad_arguments():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="mode"):
        kernels.conv3x3_fused(x, torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8), mode="add")


@pytest.mark.cuda
class TestOnCard:
    """Each CUDA kernel against its plain version on the card."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels are built with nvcc and run only there")
        # the plain versions are the reference: full f32, no TF32 in cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def test_lrp_linear(self):
        rng = np.random.default_rng(20)
        for lead, din, dout in [((3, 70), 512, 7003), ((130,), 1536, 512), ((2, 5, 196), 512, 512)]:
            r, x, z, w = (_t(a, "cuda") for a in _linear_inputs(rng, lead, din, dout))
            before = kernels.lrp_linear.launches
            got = kernels.lrp_linear(r, x, z, w)
            assert kernels.lrp_linear.launches == before + 1
            ref = kernels.lrp_linear_plain(r, x, z, w)
            torch.cuda.synchronize()
            assert _rel_err(got.cpu().numpy(), ref.cpu().numpy()) < 1e-4

    def test_lstm_gates(self):
        rng = np.random.default_rng(21)
        z = _t(rng.normal(size=(168, 2048)) * 2, "cuda")
        c = _t(rng.normal(size=(168, 512)), "cuda")
        h1, c1 = kernels.lstm_gates(z, c)
        h0, c0 = kernels.lstm_gates_plain(z, c)
        torch.testing.assert_close(h1, h0, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(c1, c0, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("mode", ["divide", "multiply"])
    def test_conv3x3_fused(self, mode):
        rng = np.random.default_rng(22)
        for n, h, w, cin, cout in [(5, 28, 28, 64, 128), (4, 14, 14, 512, 512), (3, 13, 19, 72, 20)]:
            x, k, b, r = (_t(a, "cuda") for a in _conv_inputs(rng, n, h, w, cin, cout))
            for xs in (x, x[:1].contiguous()):
                bias = b if mode == "divide" else None
                got = kernels.conv3x3_fused(xs, r, k, bias, mode=mode)
                ref = kernels.conv3x3_fused_plain(xs, r, k, bias, mode=mode)
                torch.cuda.synchronize()
                g, f = got.cpu().numpy(), ref.cpu().numpy()
                if mode == "divide":
                    ok = np.abs(r.cpu().numpy() / f) > 1e-2
                    np.testing.assert_allclose(g[ok], f[ok], rtol=1e-4, atol=1e-5)
                else:
                    assert _rel_err(g, f) < 1e-5

    def test_conv3x3_fused_rejects_misaligned_views(self):
        """A contiguous view 4 bytes into its buffer cannot take the float4
        epilogue: the wrapper raises before the launch."""
        x = torch.ones(1, 4, 4, 8, device="cuda")
        k = torch.ones(3, 3, 8, 8, device="cuda")
        ew = torch.ones(1 + 4 * 4 * 8, device="cuda")[1:].view(1, 4, 4, 8)
        bias = torch.ones(9, device="cuda")[1:]
        with pytest.raises(ValueError, match="16-byte"):
            kernels.conv3x3_fused(x, ew, k, None, mode="multiply")
        with pytest.raises(ValueError, match="16-byte"):
            kernels.conv3x3_fused(x, torch.ones(1, 4, 4, 8, device="cuda"), k, bias, mode="divide")

    def test_lrp_a1b0_fused(self):
        """bf16 kernel against its plain version: the same rounding points, so
        they differ by summation order and at most one bf16 rounding of the
        output (2^-8 of a value; 1e-2 of the map's scale)."""
        rng = np.random.default_rng(23)
        for n, h, w, cin, cout in [(20, 56, 56, 64, 64), (5, 28, 28, 128, 256),
                                   (4, 14, 14, 512, 512), (3, 13, 19, 72, 16)]:
            x, k, b, r = (_t(a, "cuda").bfloat16() for a in _conv_inputs(rng, n, h, w, cin, cout))
            x = x[:1].contiguous()   # one image shared by the n word seeds
            before = kernels.lrp_a1b0_fused.launches
            got = kernels.lrp_a1b0_fused(r, x, k, b)
            assert kernels.lrp_a1b0_fused.launches == before + 1
            ref = kernels.lrp_a1b0_fused_plain(r, x, k, b)
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, cin)
            assert _rel_err(got.float().cpu().numpy(), ref.float().cpu().numpy()) < 1e-2

    def test_lrp_a1b0_fused_rejects_bad_inputs(self):
        x = torch.ones(1, 4, 4, 8, device="cuda", dtype=torch.bfloat16)
        k = torch.ones(3, 3, 8, 8, device="cuda", dtype=torch.bfloat16)
        r = torch.ones(2, 4, 4, 8, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(TypeError, match="bfloat16"):
            kernels.lrp_a1b0_fused(r.float(), x.float(), k.float(), None)
        # a contiguous view 2 bytes into its buffer cannot take the 16-byte loads
        misaligned = torch.ones(1 + 2 * 4 * 4 * 8, device="cuda", dtype=torch.bfloat16)[1:]
        with pytest.raises(ValueError, match="16-byte"):
            kernels.lrp_a1b0_fused(misaligned.view(2, 4, 4, 8), x, k, None)
        with pytest.raises(ValueError, match="multiple of 8"):
            kernels.lrp_a1b0_fused(r[..., :4].contiguous(), x, k[..., :4].contiguous(), None)
        with pytest.raises(ValueError, match="contiguous"):
            kernels.lrp_a1b0_fused(r.transpose(1, 2), x, k, None)

    def test_wrappers_raise_on_mixed_devices(self):
        with pytest.raises(ValueError, match="tensors on"):
            kernels.lstm_gates(torch.zeros(2, 8, device="cuda"), torch.zeros(2, 2))
