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
    # the fused step takes the two gate products and the bias: z_pre as zx
    zero = torch.zeros(6, 4 * 32)
    zp, ht, ct = kernels.lstm_gates(_t(z), zero, torch.zeros(4 * 32), _t(c))
    np.testing.assert_array_equal(zp.numpy(), z)
    # elementwise transcendentals: a few ulp apart between XLA and ATen
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batch,in_dim,hidden", [(4, 10, 16), (24, 32, 8), (3, 7, 36)])
def test_lstm_step_fused_matches_jax(batch, in_dim, hidden):
    """The port's step (two matmuls, then one fused kernel call) against the
    JAX step: z_pre, h and c at rtol 1e-5, as the two frameworks sum the
    matmuls in other orders."""
    import jax

    from lrp_imagecaptioning_tpu.models import cells as jcells
    from lrp_imagecaptioning_torch.models import cells as tcells
    from lrp_imagecaptioning_torch.weights import params_from_jax

    rng = np.random.default_rng(15 + hidden)
    pj = jcells.lstm_init(jax.random.PRNGKey(hidden), in_dim, hidden)
    pj = dict(pj, b=rng.normal(size=(4 * hidden,)).astype(np.float32))   # a signed bias
    pt = params_from_jax(pj, "cpu")
    x, h, c = (rng.normal(size=s).astype(np.float32)
               for s in [(batch, in_dim), (batch, hidden), (batch, hidden)])
    sj, cj = jcells.lstm_step(pj, x, jcells.LSTMState(h, c))
    st, ct = tcells.lstm_step(pt, _t(x), tcells.LSTMState(_t(h), _t(c)))
    for got, ref in ((ct.z_pre, cj.z_pre), (st.h, sj.h), (st.c, sj.c), (ct.c, cj.c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_lstm_gates_plain_z_pre_is_the_unfused_sum():
    """z_pre of the fused plain version is bit for bit zx + zh + b, the sum
    the unfused step took (and the decoder LRP reads back)."""
    rng = np.random.default_rng(16)
    zx, zh = (_t(rng.normal(size=(7, 4 * 12)) * 3) for _ in range(2))
    b = _t(rng.normal(size=(4 * 12,)))
    c = _t(rng.normal(size=(7, 12)))
    z_pre, h, c_new = kernels.lstm_gates(zx, zh, b, c)
    assert torch.equal(z_pre, zx + zh + b)
    h0, c0 = kernels.lstm_gates_plain(zx + zh + b, torch.zeros_like(zx), torch.zeros_like(b), c)[1:]
    assert torch.equal(h, h0) and torch.equal(c_new, c0)


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


# (M, N = Din, K = Dout) of the decoder backward's products at batch 8 and 56
# (M = batch * 20 words; W_img's rows also run over the 196 grid cells), and
# ragged and tiny cases
SPLIT_SHAPES = [(160, 512, 7003), (1120, 512, 7003), (160, 1536, 512), (1120, 1536, 512),
                (160, 512, 512), (1120, 512, 512), (31360, 512, 512), (219520, 512, 512),
                (30, 24, 37), (1, 1, 1), (5, 7, 64), (200, 130, 9),
                # grid-TD's TD-LSTM gate block (K = H + 2E + H = 2048), batch 8 and 56
                (160, 2048, 512), (1120, 2048, 512)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("m,n,k", SPLIT_SHAPES)
def test_lrp_linear_splits_cover_k(m, n, k, sms):
    splits = kernels.lrp_linear_splits(m, n, k, sms)
    assert splits >= 1
    # the kernel's cut (csrc/lrp_linear.cu): ceil(slices / splits) k-slices a split
    slices = -(-k // kernels.LINEAR_BK)
    step = -(-slices // splits) * kernels.LINEAR_BK
    ranges = [(s * step, min(k, (s + 1) * step)) for s in range(splits)]
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1                      # contiguous, no overlap
    for b, e in ranges:
        assert b < e                         # every split sums something
        assert b % kernels.LINEAR_BK == 0    # whole k-slices: aligned float4 loads
    tiles = -(-m // kernels.LINEAR_TILE) * -(-n // kernels.LINEAR_TILE)
    if tiles >= 2 * sms:
        assert splits == 1                   # enough blocks without a split


def test_lrp_linear_splits_on_the_main_path():
    """The thin products split at both batches, W_img never; grid-TD's gate
    blocks (K = 1536 and 2048) at batch 8."""
    split = {shape: kernels.lrp_linear_splits(*shape, 132) for shape in SPLIT_SHAPES}
    assert split[(160, 512, 7003)] > 1 and split[(1120, 512, 7003)] > 1
    assert split[(160, 1536, 512)] > 1 and split[(160, 512, 512)] > 1
    assert split[(160, 2048, 512)] > 1
    assert split[(31360, 512, 512)] == 1 and split[(219520, 512, 512)] == 1


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 5, 7, 8, 16), (1, 4, 4, 12, 24)])
def test_a1b0_taps_are_the_transposed_conv(n, h, w, cin, cout):
    """The bf16 rule's kernel reads W+ (HWIO, as the wrapper passes it) as
    9 (Cin, Cout) matrices, tap t = 3 dy + dx at kp[8 - t], i.e. W+ flipped
    in both spatial axes, and sums s at the shifted pixel (h + dy - 1,
    w + dx - 1) times tap t over Cout: an implicit GEMM equal to the
    transposed conv."""
    from lrp_imagecaptioning_torch.ops.lrp_conv import conv2d_input_vjp

    rng = np.random.default_rng(14)
    kp = torch.from_numpy(np.abs(rng.normal(size=(3, 3, cin, cout))))
    s = torch.from_numpy(rng.normal(size=(n, h, w, cout)))
    taps = kp.reshape(9, cin, cout)   # the kernel's view of the contiguous HWIO tensor
    torch.testing.assert_close(taps.flip(0), kp.flip(0, 1).reshape(9, cin, cout), rtol=0, atol=0)
    s_pad = torch.nn.functional.pad(s, (0, 0, 1, 1, 1, 1))   # SAME zeros outside the image
    got = sum(s_pad[:, dy:dy + h, dx:dx + w, :] @ taps[8 - (3 * dy + dx)].T
              for dy in range(3) for dx in range(3))
    torch.testing.assert_close(got, conv2d_input_vjp(kp, s), rtol=1e-12, atol=1e-12)


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
        """Split-K with scalar loads (K = 7003 at M = 160 and 1120), split-K
        with float4 loads (gate_g at M = 160), no split (W_img at 196 cells)."""
        rng = np.random.default_rng(20)
        for lead, din, dout in [((3, 70), 512, 7003), ((130,), 1536, 512), ((2, 5, 196), 512, 512),
                                ((160,), 512, 7003), ((1120,), 512, 7003), ((160,), 1536, 512)]:
            r, x, z, w = (_t(a, "cuda") for a in _linear_inputs(rng, lead, din, dout))
            before = kernels.lrp_linear.launches
            got = kernels.lrp_linear(r, x, z, w)
            assert kernels.lrp_linear.launches == before + 1
            ref = kernels.lrp_linear_plain(r, x, z, w)
            torch.cuda.synchronize()
            assert _rel_err(got.cpu().numpy(), ref.cpu().numpy()) < 1e-4

    def test_lrp_linear_largest_grid(self):
        """W_img at the bf16 path's batch 56: M = 56 * 20 * 196 = 219 520 rows,
        6 860 blocks; inputs made on the card."""
        gen = torch.Generator(device="cuda").manual_seed(24)
        m, d = 219_520, 512
        r, z, x = (torch.randn(m, d, generator=gen, device="cuda") for _ in range(3))
        w = torch.randn(d, d, generator=gen, device="cuda") / d ** 0.5
        before = kernels.lrp_linear.launches
        got = kernels.lrp_linear(r, x, z, w)
        assert kernels.lrp_linear.launches == before + 1
        ref = kernels.lrp_linear_plain(r, x, z, w)
        torch.cuda.synchronize()
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err < 1e-4

    def test_lstm_gates(self):
        """The fused step tail at the beam's batch 3 x 56 (B = 168), against
        its plain version: z_pre bit for bit, h and c within a few ulp."""
        rng = np.random.default_rng(21)
        zx, zh = (_t(rng.normal(size=(168, 2048)), "cuda") for _ in range(2))
        b = _t(rng.normal(size=(2048,)), "cuda")
        c = _t(rng.normal(size=(168, 512)), "cuda")
        z1, h1, c1 = kernels.lstm_gates(zx, zh, b, c)
        z0, h0, c0 = kernels.lstm_gates_plain(zx, zh, b, c)
        assert torch.equal(z1, z0)
        torch.testing.assert_close(h1, h0, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(c1, c0, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("batch,hidden", [(24, 512), (168, 512), (56, 512), (5, 36), (3, 1028)])
    def test_lstm_gates_fused_shapes(self, batch, hidden):
        """B = 24 and 168 (the beam at batch 8 and 56), 56 (the cached forward
        at batch 56), and H that leaves the last block part full (36, 1028)."""
        gen = torch.Generator(device="cuda").manual_seed(batch + hidden)
        zx, zh = (torch.randn(batch, 4 * hidden, generator=gen, device="cuda") * 2
                  for _ in range(2))
        b = torch.randn(4 * hidden, generator=gen, device="cuda")
        c = torch.randn(batch, hidden, generator=gen, device="cuda")
        before = kernels.lstm_gates.launches
        got = kernels.lstm_gates(zx, zh, b, c)
        assert kernels.lstm_gates.launches == before + 1
        ref = kernels.lstm_gates_plain(zx, zh, b, c)
        assert torch.equal(got[0], ref[0])
        for g, r in zip(got[1:], ref[1:]):
            assert (g - r).abs().max().item() <= 1e-5

    def test_lstm_gates_rejects_bad_inputs(self):
        zx = torch.zeros(2, 4 * 6, device="cuda")
        with pytest.raises(ValueError, match="multiple of 4"):
            kernels.lstm_gates(zx, zx, torch.zeros(24, device="cuda"),
                               torch.zeros(2, 6, device="cuda"))
        zx = torch.zeros(2, 32, device="cuda")
        misaligned = torch.zeros(1 + 2 * 32, device="cuda")[1:].view(2, 32)
        with pytest.raises(ValueError, match="16-byte"):
            kernels.lstm_gates(zx, misaligned, torch.zeros(32, device="cuda"),
                               torch.zeros(2, 8, device="cuda"))

    @pytest.mark.parametrize("mode", ["divide", "multiply"])
    def test_conv3x3_fused(self, mode):
        """Signed taps, so z cancels in places: where |z| > 1e-2 the sum of
        the terms' magnitudes is up to 3e4 times |z|, and an f32 quotient's
        last digits depend on the order of the sum. The divide pass is held
        to the plain version in f64 there, at two fixed limits, each quotient:

        * |q - q64| <= 5e-4 |q64|;
        * |q - q64| / |q64| <= 4 * 2^-24 times that condition number,
          kappa = (|x| * |W| summed + |b|) / |z|: f32-grade sums.

        On an H100 80GB HBM3 (scripts/k3_divide_accuracy.py) the kernel read
        3.7e-4 and 1.1e-7; the f32 plain version (cuDNN) 1.7e-3 and 3.4e-7,
        and the same conv in TF32 0.88 and 1.0e-4. The former kernel summed
        in cuDNN's order and matched it bit for bit, which the test checked
        before (rtol 1e-4 against the f32 plain version)."""
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
                    x64, k64, b64 = xs.double(), k.double(), bias.double()
                    q64 = kernels.conv3x3_fused_plain(x64, r.double(), k64, b64, mode=mode)
                    z64 = kernels.conv2d(x64, k64) + b64
                    kappa = (kernels.conv2d(x64.abs(), k64.abs()) + b64.abs()) / z64.abs()
                    q64, kappa = q64.cpu().numpy(), kappa.expand_as(r).cpu().numpy()
                    ok = np.abs(r.cpu().numpy() / f) > 1e-2
                    assert ok.mean() > 0.9
                    dist = (np.abs(g - q64) / np.abs(q64))[ok]
                    assert dist.max() <= 5e-4
                    assert (dist / kappa[ok]).max() <= 4 * 2.0 ** -24
                else:
                    assert _rel_err(g, f) < 1e-5

    @pytest.mark.parametrize("w", [14, 19, 21])
    @pytest.mark.parametrize("cin,cout", [(64, 8), (128, 64), (512, 512), (64, 512), (512, 8)])
    def test_conv3x3_fused_edges(self, w, cin, cout):
        """3xTF32 against the plain version in f64 at 1e-4 of scale: W a
        multiple of the 16-pixel tile or not, Cout below, at and above a
        column tile, the divide pass with x shared by N = 20 words (Nc = 1;
        its grid takes the small tile) and the multiply pass with x shared
        (Ne = 1), and z exactly 0 (zero bias over all-zero windows of x).
        Where z == 0 the multiply pass's input s = r / 1e-7 spans seven
        decades, and cuDNN's f32 conv (the f32 plain version) then lies up to
        1.6x the map's scale from f64 (W = 21, Cin 64, Cout 512): f64 is the
        reference; the quotients at z == 0 are checked bit for bit against
        the f32 plain version."""
        gen = torch.Generator(device="cuda").manual_seed(w * cin + cout)
        n, h = 20, 14
        x = torch.relu(torch.randn(1, h, w, cin, generator=gen, device="cuda"))
        x[:, 2:6, 3:8] = 0
        kp = torch.rand(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
        b = torch.rand(cout, generator=gen, device="cuda") * 0.01
        b[: cout // 2] = 0
        r = torch.randn(n, h, w, cout, generator=gen, device="cuda")
        z = kernels.conv2d(x, kp) + b
        assert int((z == 0).sum()) > 0
        kt = kernels.flip_transpose_kernel(kp)
        before = kernels.conv3x3_fused.launches
        s = kernels.conv3x3_fused(x, r, kp, b, "divide")
        s_ref = kernels.conv3x3_fused_plain(x, r, kp, b, "divide")
        out = kernels.conv3x3_fused(s_ref, x, kt, None, "multiply")
        assert kernels.conv3x3_fused.launches == before + 2
        s64 = kernels.conv3x3_fused_plain(x.double(), r.double(), kp.double(), b.double(), "divide")
        out64 = kernels.conv3x3_fused_plain(s_ref.double(), x.double(), kt.double(), None,
                                            "multiply")
        torch.cuda.synchronize()
        assert s.shape == (n, h, w, cout) and out.shape == (n, h, w, cin)
        # where z == 0 both divide r by 1e-7 exactly
        zero = (z == 0).expand_as(r)
        assert torch.equal(s[zero], s_ref[zero])
        for got, ref in ((s, s64), (out, out64)):
            assert _rel_err(got.double().cpu().numpy(), ref.cpu().numpy()) < 1e-4

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
        # 1 and 20 words; W a multiple of 16 or not (14^2, 13x19, 9x21); Cout a
        # multiple of the Cout chunk or not (16 channels at Cin <= 64: 24;
        # 32 above: 8, 16); Cin a whole 64- or 128-channel tile or not (32,
        # 72, 192); z exactly 0
        for n, h, w, cin, cout, zeros in [
                (20, 56, 56, 64, 64, False), (1, 28, 28, 128, 256, False),
                (4, 14, 14, 512, 512, False), (3, 13, 19, 72, 16, False),
                (2, 13, 19, 192, 8, False), (20, 14, 14, 64, 48, False),
                (5, 9, 21, 32, 24, False), (3, 16, 16, 128, 64, True)]:
            x, k, b, r = (_t(a, "cuda").bfloat16() for a in _conv_inputs(rng, n, h, w, cin, cout))
            x = x[:1].contiguous()   # one image shared by the n word seeds
            if zeros:
                # zero bias and all-zero 3x3 windows of x: z == 0 exactly, s = r / 1e-7
                b = torch.zeros_like(b)
                x[:, 2:7, 3:9] = 0
                x[:, 11:, 12:] = 0
                z = kernels.conv2d(x, k * (k >= 0))
                assert int((z == 0).sum()) > 0
            before = kernels.lrp_a1b0_fused.launches
            got = kernels.lrp_a1b0_fused(r, x, k, b)
            assert kernels.lrp_a1b0_fused.launches == before + 1
            ref = kernels.lrp_a1b0_fused_plain(r, x, k, b)
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, cin)
            assert _rel_err(got.float().cpu().numpy(), ref.float().cpu().numpy()) < 1e-2

    def test_lrp_a1b0_fused_divides_exactly(self):
        """W+ the identity at the centre tap leaves one exact product per
        output, so the kernel's out must equal bf16(x * bf16(r / safe(z)))
        bit for bit, over r from 2^-100 to 2^100 (past the divide's fast
        range both ways) and z with exact zeros, on both block tiles
        (C = 64 and 128)."""
        gen = torch.Generator(device="cuda").manual_seed(25)
        n, h, w = 6, 30, 35
        for c in (64, 128):
            k = torch.zeros(3, 3, c, c, device="cuda")
            k[1, 1] = torch.eye(c, device="cuda")
            x = torch.rand(1, h, w, c, generator=gen, device="cuda") * 4
            x[:, :, :3] = 0                  # z = b there, exactly 0 where b is
            b = torch.randn(c, generator=gen, device="cuda")
            b[:8] = 0
            scale = 2.0 ** torch.randint(-100, 101, (n, h, w, c), generator=gen, device="cuda")
            r = torch.randn(n, h, w, c, generator=gen, device="cuda") * scale
            r, x, k, b = (t.bfloat16() for t in (r, x, k, b))
            got = kernels.lrp_a1b0_fused(r, x, k, b)
            zf = kernels._positive_z(x, k, b)[1].float()
            assert int((zf == 0).sum()) > 0
            s = (r.float() / (zf + (zf == 0).float() * 1e-7)).bfloat16()
            assert torch.equal(got, (x.float() * s.float()).bfloat16())

    def test_lrp_linear_divides_exactly(self):
        """W the identity leaves one exact product per output: the kernel's
        out must equal x * (r / stab(z)) bit for bit, with float4 loads
        (K = 64) and scalar ones (K = 67), r from 2^-100 to 2^100."""
        gen = torch.Generator(device="cuda").manual_seed(26)
        for m, k in ((300, 64), (300, 67)):
            scale = 2.0 ** torch.randint(-100, 101, (m, k), generator=gen, device="cuda")
            r = torch.randn(m, k, generator=gen, device="cuda") * scale
            z = torch.randn(m, k, generator=gen, device="cuda")
            z[:, :5] = 0
            x = torch.randn(m, k, generator=gen, device="cuda")
            got = kernels.lrp_linear(r, x, z, torch.eye(k, device="cuda"))
            assert torch.equal(got, x * (r / (z + torch.where(z >= 0, 1e-7, -1e-7))))

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
            z = torch.zeros(2, 8, device="cuda")
            kernels.lstm_gates(z, z, torch.zeros(8, device="cuda"), torch.zeros(2, 2))
