"""The hand-written Hopper kernels of the caption + explain path, with their
plain PyTorch versions and launch counters.

Every wrapper takes the plain version for a tensor on the CPU and launches
its CUDA kernel (``csrc/*.cu``, built by ``_build.py``) for a tensor on the
card, or raises: nothing falls back. Each counts its launches in the integer
attribute ``<wrapper>.launches``; ``reset_launches()`` sets them to 0.

Gradients on the card: ``lstm_gates`` runs through the ``LSTMGates``
autograd Function when an input requires grad (the forward is the kernel,
the backward ``lstm_gates_vjp`` in torch ops; the JAX package differentiates
the jnp cell, so there is no backward kernel to port). ``lrp_linear``,
``conv3x3_fused`` and ``lrp_a1b0_fused`` have no backward in either package:
on the card they raise when autograd would have to differentiate them, rather
than return an output without history. On the CPU the plain versions are
differentiated by autograd as they are.

==============  ========================  ============================================================
wrapper         CUDA source               TPU kernel it replaces
==============  ========================  ============================================================
lrp_linear      csrc/lrp_linear.cu        lrp_imagecaptioning_tpu/ops/pallas_kernels.py:_lrp_linear_kernel
lstm_gates      csrc/lstm_gates.cu        lrp_imagecaptioning_tpu/ops/pallas_kernels.py:_lstm_gates_kernel
conv3x3_fused   csrc/conv3x3_fused.cu     lrp_imagecaptioning_tpu/ops/pallas_conv_lrp.py:_conv3x3_kernel
lrp_a1b0_fused  csrc/lrp_a1b0_fused.cu    experiments/pallas_block1_v2.py:_kernel and :_kernel_v3
==============  ========================  ============================================================

Each source's header says what bounds the kernel on the H100 and what its
design does about it.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .lrp_conv import conv2d, conv2d_input_vjp
from .lrp_core import EPS_KERAS, lrp_linear as lrp_linear_plain, safe_divide


def _check_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float32) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors (shape {tuple(t.shape)})")
    return dev


def _no_grad_only(name: str, *tensors) -> None:
    """Raise if autograd would have to differentiate a kernel that has none."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no gradient and an input requires "
                           "grad; run it under torch.no_grad()")


def _launch(name: str, dev: torch.device, *args) -> None:
    fn = _build.kernel_fn(name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")


# ---------------------------------------------------------------------------
# K1  lrp_linear: rel = x * ((r / stab(z)) @ W^T)
# ---------------------------------------------------------------------------


LINEAR_TILE = 128   # csrc/lrp_linear.cu: BM = BN
LINEAR_BK = 8       # k-slice depth
LINEAR_MIN_SLICES = 8   # k-slices a split takes at least


def lrp_linear_splits(m: int, n: int, k: int, sms: int) -> int:
    """How many splits of K the ``lrp_linear`` kernel takes: as many as
    still fit the blocks into one wave of two per SM where the M x N tiles
    alone fill less, each split at least LINEAR_MIN_SLICES k-slices deep.
    The kernel gives each split ceil(slices / splits) k-slices of
    LINEAR_BK; the count returned leaves none empty."""
    tiles = -(-m // LINEAR_TILE) * -(-n // LINEAR_TILE)
    slices = -(-k // LINEAR_BK)
    splits = max(1, min(2 * sms // tiles, slices // LINEAR_MIN_SLICES))
    per = -(-slices // splits)
    return -(-slices // per)


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def lrp_linear(r: torch.Tensor, x: torch.Tensor, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """epsilon-LRP (eps = 1e-7) through ``z = x @ w``: r, z (..., Dout);
    x (..., Din); w (Din, Dout). Leading dims flatten into the kernel's M rows."""
    if x.device.type == "cpu":
        return lrp_linear_plain(r, x, z, w)
    _no_grad_only("lrp_linear", r, x, z, w)
    dev = _check_cuda("lrp_linear", r, x, z, w)
    din, dout = w.shape
    if x.shape[-1] != din or r.shape[-1] != dout or z.shape != r.shape \
            or r.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"lrp_linear: shapes r {tuple(r.shape)}, x {tuple(x.shape)}, "
                         f"z {tuple(z.shape)}, w {tuple(w.shape)}")
    m = x.numel() // din
    out = torch.empty_like(x)
    splits = lrp_linear_splits(m, din, dout, _sm_count(dev))
    part = torch.empty((splits, m, din), dtype=torch.float32, device=dev) if splits > 1 else None
    # w is (Din, Dout) row-major: exactly the kernel's (N, K) operand
    _launch("lrp_linear_f32", dev, r.data_ptr(), z.data_ptr(), x.data_ptr(), w.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), m, dout, din, splits)
    lrp_linear.launches += 1
    return out


lrp_linear.launches = 0


# ---------------------------------------------------------------------------
# K2  LSTM step tail: (zx, zh (B, 4H) [i, f, g, o], b (4H,), c_prev (B, H))
#     -> (z_pre = zx + zh + b, h, c)
# ---------------------------------------------------------------------------


def lstm_gates_plain(zx: torch.Tensor, zh: torch.Tensor, bias: torch.Tensor,
                     c_prev: torch.Tensor):
    z_pre = zx + zh + bias
    zi, zf, zg, zo = z_pre.chunk(4, dim=-1)
    c = torch.sigmoid(zf) * c_prev + torch.sigmoid(zi) * torch.tanh(zg)
    h = torch.sigmoid(zo) * torch.tanh(c)
    return z_pre, h, c


def lstm_gates_vjp(z_pre, c_prev, c, dz_pre, dh, dc):
    """The gradient of ``lstm_gates_plain`` from its saved ``z_pre``, ``c_prev``
    and ``c``: cotangents (dz_pre, dh, dc) -> (dz, dbias, dc_prev), where dz is
    the gradient of zx and of zh alike. With i, f, o = sigmoid and g = tanh
    of z_pre's four blocks:

        dc_tot = dc + dh o (1 - tanh^2 c)
        dz     = [dc_tot g i(1-i), dc_tot c_prev f(1-f), dc_tot i (1-g^2),
                  dh tanh(c) o(1-o)] + dz_pre
        dbias  = dz summed over the batch;   dc_prev = dc_tot f"""
    zi, zf, zg, zo = z_pre.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    g, tc = torch.tanh(zg), torch.tanh(c)
    dc_tot = dc + dh * o * (1.0 - tc * tc)
    dz = torch.cat([dc_tot * g * i * (1.0 - i), dc_tot * c_prev * f * (1.0 - f),
                    dc_tot * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1) + dz_pre
    return dz, dz.reshape(-1, dz.shape[-1]).sum(dim=0), dc_tot * f


class LSTMGates(torch.autograd.Function):
    """K2 with a gradient: the forward is the CUDA kernel, the backward
    ``lstm_gates_vjp`` in torch ops."""

    @staticmethod
    def forward(ctx, zx, zh, bias, c_prev):
        z_pre, h, c = _lstm_gates_launch(zx, zh, bias, c_prev)
        ctx.save_for_backward(z_pre, c_prev, c)
        return z_pre, h, c

    @staticmethod
    def backward(ctx, dz_pre, dh, dc):
        dz, dbias, dc_prev = lstm_gates_vjp(*ctx.saved_tensors, dz_pre, dh, dc)
        return dz, dz, dbias, dc_prev


def lstm_gates(zx: torch.Tensor, zh: torch.Tensor, bias: torch.Tensor, c_prev: torch.Tensor):
    """The gate pre-activations ``z_pre = (zx + zh) + bias``, then the gate
    nonlinearities and the cell update, in one launch; returns (z_pre, h, c).
    zx = x @ W_i and zh = h_prev @ W_h: (B, 4H); bias (4H,); c_prev (B, H).
    On the card an input that requires grad takes ``LSTMGates``."""
    if zx.device.type == "cpu":
        return lstm_gates_plain(zx, zh, bias, c_prev)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (zx, zh, bias, c_prev)):
        return LSTMGates.apply(zx, zh, bias, c_prev)
    return _lstm_gates_launch(zx, zh, bias, c_prev)


def _lstm_gates_launch(zx, zh, bias, c_prev):
    dev = _check_cuda("lstm_gates", zx, zh, bias, c_prev)
    hidden = c_prev.shape[-1]
    if (zx.shape != zh.shape or zx.shape[:-1] != c_prev.shape[:-1]
            or zx.shape[-1] != 4 * hidden or tuple(bias.shape) != (4 * hidden,)):
        raise ValueError(f"lstm_gates: zx {tuple(zx.shape)}, zh {tuple(zh.shape)}, "
                         f"bias {tuple(bias.shape)}, c_prev {tuple(c_prev.shape)}")
    if hidden % 4:
        raise ValueError(f"lstm_gates: H must be a multiple of 4 (float4 loads), got {hidden}")
    if any(t.data_ptr() % 16 for t in (zx, zh, bias, c_prev)):
        raise ValueError("lstm_gates: zx, zh, bias and c_prev must start on a 16-byte boundary "
                         "(float4 loads)")
    z_pre = torch.empty_like(zx)
    h = torch.empty_like(c_prev)
    c = torch.empty_like(c_prev)
    _launch("lstm_gates_f32", dev, zx.data_ptr(), zh.data_ptr(), bias.data_ptr(),
            c_prev.data_ptr(), z_pre.data_ptr(), h.data_ptr(), c.data_ptr(),
            c_prev.numel() // hidden, hidden)
    lstm_gates.launches += 1
    return z_pre, h, c


lstm_gates.launches = 0


# ---------------------------------------------------------------------------
# K3  3x3 SAME conv + elementwise epilogue, and the alpha1beta0 rule on it
# ---------------------------------------------------------------------------

MODES = ("divide", "multiply")


def conv3x3_fused_plain(x, ew, kernel, bias=None, mode: str = "divide"):
    acc = conv2d(x, kernel)
    if mode == "divide":
        return safe_divide(ew, acc if bias is None else acc + bias)
    return ew * acc


def conv3x3_fused(x: torch.Tensor, ew: torch.Tensor, kernel: torch.Tensor,
                  bias: torch.Tensor | None = None, mode: str = "divide") -> torch.Tensor:
    """``divide``: ew / safe(conv(x, kernel) + bias); ``multiply``: ew * conv(x, kernel).
    safe() adds eps = 1e-7 where its argument is exactly 0.

    x: (Nc, H, W, Cin) conv input; ew: (Ne, H, W, Cout); kernel: (3, 3, Cin, Cout)
    HWIO; bias: (Cout,) or None. Nc and Ne are each 1 or N: a batch-1 operand is
    shared by all N rows of the (N, H, W, Cout) result. On the card Cin and Cout
    are multiples of 4 and every tensor starts on a 16-byte boundary."""
    if mode not in MODES:
        raise ValueError(f"conv3x3_fused: mode {mode!r} not in {MODES}")
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, ew, kernel, bias, mode)
    tensors = (x, ew, kernel) if bias is None else (x, ew, kernel, bias)
    _no_grad_only("conv3x3_fused", *tensors)
    dev = _check_cuda("conv3x3_fused", *tensors)
    nc, h, w, cin = x.shape
    ne, cout = ew.shape[0], ew.shape[-1]
    n = max(nc, ne)
    if (ew.shape[1:3] != (h, w) or tuple(kernel.shape) != (3, 3, cin, cout)
            or nc not in (1, n) or ne not in (1, n)
            or (bias is not None and tuple(bias.shape) != (cout,))):
        raise ValueError(f"conv3x3_fused: x {tuple(x.shape)}, ew {tuple(ew.shape)}, "
                         f"kernel {tuple(kernel.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    if cout % 4 or cin % 4:
        raise ValueError(f"conv3x3_fused: Cin and Cout must be multiples of 4 (16-byte copies), "
                         f"got Cin {cin}, Cout {cout}")
    if mode == "multiply" and bias is not None:
        raise ValueError("conv3x3_fused: bias applies to the divide mode only")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("conv3x3_fused: x, ew, kernel and bias must start on a 16-byte "
                             "boundary (16-byte copies)")
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=dev)
    _launch("conv3x3_fused_f32", dev, x.data_ptr(), ew.data_ptr(), kernel.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), n, nc, ne, h, w, cin, cout,
            int(mode == "divide"))
    conv3x3_fused.launches += 1
    return out


conv3x3_fused.launches = 0


def flip_transpose_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3,3,Cin,Cout) -> (3,3,Cout,Cin) spatially flipped: the kernel of the
    transposed conv as a plain SAME conv."""
    return kernel.flip(0, 1).permute(0, 1, 3, 2).contiguous()


def lrp_conv_a1b0(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                  bias: torch.Tensor | None) -> torch.Tensor:
    """alpha1beta0 conv LRP for x >= 0 as two fused passes (the composition of
    ops/pallas_conv_lrp.py:lrp_conv_a1b0_pallas):

        s   = r / safe(conv(x, W+) + b)       (z takes the full bias b+ + b-)
        out = x * conv(s, flipT(W+))

    r: (N, H, W, Cout); x: (1 or N, H, W, Cin), shared by all N seeds."""
    kp = (kernel * (kernel >= 0)).contiguous()
    s = conv3x3_fused(x, r, kp, bias, mode="divide")
    return conv3x3_fused(s, x, flip_transpose_kernel(kp), None, mode="multiply")


# ---------------------------------------------------------------------------
# K4/K5  the alpha1beta0 rule in one kernel, bf16 storage
# ---------------------------------------------------------------------------


def _positive_z(x, kernel, bias):
    """(W+, z = conv(x, W+) + b), both in the dtype of the inputs."""
    kp = kernel * (kernel >= 0)
    z = conv2d(x, kp)
    return kp, z if bias is None else z + bias


def lrp_a1b0_fused_plain(r, x, kernel, bias, eps: float = EPS_KERAS):
    """The rule with the kernel's rounding points: z in the storage dtype,
    s = r / safe(z) in f32 rounded once, an f32 transposed conv, the x
    re-weight in f32 rounded once. safe() adds ``eps`` where z is exactly 0
    (1e-7, SafeDivide's; experiments/pallas_block1_v2.py uses 0.01)."""
    kp, z = _positive_z(x, kernel, bias)
    zf = z.float()
    s = (r.float() / (zf + (zf == 0).float() * eps)).to(r.dtype)
    return (x.float() * conv2d_input_vjp(kp.float(), s.float())).to(r.dtype)


def lrp_a1b0_fused(r: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor | None) -> torch.Tensor:
    """alpha1beta0 conv LRP for x >= 0 in bf16 storage, one kernel launch:

        z   = conv(x, W+) + b                      (bf16, F.conv2d, once per x)
        out = x * convT(r / safe(z), W+)           (the kernel)

    r: (N, H, W, Cout); x: (1, H, W, Cin), shared by the N seeds; kernel:
    (3, 3, Cin, Cout) HWIO; bias: (Cout,) or None; all bf16. Returns
    (N, H, W, Cin) bf16."""
    if x.device.type == "cpu":
        return lrp_a1b0_fused_plain(r, x, kernel, bias)
    tensors = (r, x, kernel) if bias is None else (r, x, kernel, bias)
    _no_grad_only("lrp_a1b0_fused", *tensors)
    dev = _check_cuda("lrp_a1b0_fused", *tensors, dtype=torch.bfloat16)
    n, h, w, cout = r.shape
    cin = x.shape[-1]
    if (tuple(x.shape) != (1, h, w, cin) or tuple(kernel.shape) != (3, 3, cin, cout)
            or (bias is not None and tuple(bias.shape) != (cout,))):
        raise ValueError(f"lrp_a1b0_fused: r {tuple(r.shape)}, x {tuple(x.shape)}, "
                         f"kernel {tuple(kernel.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    if cout % 8 or cin % 4:
        raise ValueError(f"lrp_a1b0_fused: Cout must be a multiple of 8 and Cin of 4 "
                         f"(vector loads), got Cout {cout}, Cin {cin}")
    if r.data_ptr() % 16 or x.data_ptr() % 8:
        raise ValueError("lrp_a1b0_fused: r must start on a 16-byte boundary and x on an "
                         "8-byte one (vector loads)")
    kp, z = _positive_z(x, kernel, bias)
    out = torch.empty((n, h, w, cin), dtype=torch.bfloat16, device=dev)
    # the kernel reads W+ (HWIO) with its taps flipped in the index: no copy
    _launch("lrp_a1b0_fused_bf16", dev, r.data_ptr(), z.data_ptr(), x.data_ptr(),
            kp.data_ptr(), out.data_ptr(), n, h, w, cin, cout)
    lrp_a1b0_fused.launches += 1
    return out


lrp_a1b0_fused.launches = 0


KERNELS = (lrp_linear, lstm_gates, conv3x3_fused, lrp_a1b0_fused)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
