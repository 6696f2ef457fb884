"""The LRP-inference fine-tune entry on a ResNet encoder: the K-step call of
``make_multi_lrp_finetune_step``, each step replayed from its captured
graph, with the residual walk inside ``lrp_weights``. The window, the
clock and the check are the training entry's (``entries/train.py``); what
differs is the params (a ResNet tree with BatchNorm leaves), the reference
(``reference.resnet``) and the counters a traced run reads.

Weights from the seed: glorot-uniform kernels and embedding, zero biases,
the LSTM forget bias 1 (``inputs.make_params``' laws); BN's gamma
U(0.5, 1), on the last BN of each block's branch ('2c') U(0.1, 0.2), as
trained ResNets keep their residual branches small; beta U(-0.2, 0.2);
the moving statistics calibrated in set-up on ``CALIBRATION_IMAGES``
N(0, 1) images of the seed: each BN's mean is its input's channel mean
plus U(-0.25, 0.25) of its channel's deviation, its variance the channel's
variance times U(0.8, 1.25). Every BN output is so of the order of its
gamma, the residual stream stays O(1) through all 33 blocks (RMS 0.6-1.0
at 224x224), and no BN is the identity (beta and the mean nonzero: with
both 0 the BN rule hands R back unchanged). With the branches' gamma at
U(0.5, 1) the stream grows to RMS 3.4 in stage 4 and a float32 forward
drifts 5e-4 from float64 over the 104 convs, against 6e-6 here."""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from perfbench.entries import train
from perfbench.entries.train import check, leaf_norms  # noqa: F401  (run.py calls check)
from perfbench.harness import inputs
from perfbench.reference import model, resnet
from perfbench.reference import steps as ref
from perfbench.reference.model import leaves, mask_rows

CALIBRATION_IMAGES = 8
PHASES = ("predict", "lrp_weights", "update")


def param_layout(s) -> dict:
    """The params tree as (shape, law) leaves, the program's layout for a
    ResNet encoder (``{'vgg': convs and BNs, 'decoder': ...}``): the
    decoder's leaves as ``model.param_layout`` gives them, a kernel's law
    ('glorot', kh kw cin, kh kw cout), a BN leaf's ('bn', its name)."""
    dec = model.param_layout(dataclasses.replace(s, arch="vgg16", until="block1_conv1"))
    enc = {}
    for name, bn, (kh, kw, ci, co), _ in resnet.convs(s.arch):
        enc[name] = {"kernel": ((kh, kw, ci, co), ("glorot", kh * kw * ci, kh * kw * co))}
        enc[bn] = {k: ((co,), ("bn", k)) for k in ("gamma", "beta", "moving_mean", "moving_var")}
    return {"vgg": enc, "decoder": dec["decoder"]}


def make_params(s, seed: int, device) -> dict:
    """Every weight from the seed (the module's laws), the BN statistics
    calibrated on images of the seed."""
    flat = leaves(param_layout(s))
    total = sum(math.prod(shape) for _, (shape, law) in flat if law[0] == "glorot")
    u = torch.rand(total, generator=inputs.generator(seed, 0, device), device=device) * 2 - 1
    bn_gen = inputs.generator(seed, 3, device)
    out, at = {}, 0
    for path, (shape, law) in flat:
        n = math.prod(shape)
        if law[0] == "glorot":
            t = u[at:at + n].reshape(shape) * math.sqrt(6.0 / (law[1] + law[2]))
            at += n
        elif law == ("bn", "gamma"):
            lo = 0.1 if path.endswith("2c/gamma") else 0.5
            t = lo + lo * torch.rand(shape, generator=bn_gen, device=device)
        elif law == ("bn", "beta"):
            t = 0.4 * torch.rand(shape, generator=bn_gen, device=device) - 0.2
        else:
            t = torch.zeros(shape, device=device)
            if law[0] == "forget_one":
                t[law[1]:2 * law[1]] = 1.0
            elif law == ("bn", "moving_var"):
                t += 1.0
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t.contiguous()

    def calibrate(bn_name, z):
        p = out["vgg"][bn_name]
        mean, var = z.mean(dim=(0, 1, 2)), z.var(dim=(0, 1, 2), unbiased=False)
        var = var.clamp(min=1e-2 * float(var.mean()) + 1e-12)
        shift = 0.5 * torch.rand(mean.shape, generator=bn_gen, device=device) - 0.25
        scale = 0.8 + 0.45 * torch.rand(mean.shape, generator=bn_gen, device=device)
        p["moving_mean"].copy_(mean + shift * var.sqrt())
        p["moving_var"].copy_(var * scale)

    images = inputs.images(CALIBRATION_IMAGES, s.image, inputs.generator(seed, 4, device))
    with torch.no_grad():
        resnet.forward(out["vgg"], images, s.arch, on_conv=calibrate)
    return out


class Entry(train.Entry):
    """``train.Entry`` with a ResNet params tree, the ResNet reference and
    the fine-tune step's phase counters."""

    def __init__(self, cell, seed: int, device, group=None):
        from lrp_imagecaptioning_torch.config import COCOConfig
        from lrp_imagecaptioning_torch.models.captioner import build_captioner
        from lrp_imagecaptioning_torch.runtime import resolve_device
        from lrp_imagecaptioning_torch.train.optimizer import Adam

        if group is not None:
            raise ValueError("the ResNet fine-tune entry runs on one card")
        tr, s, conf = cell.traffic, cell.sizes, cell.config
        # the program's device policy, as its entry points apply it (TF32 off)
        device = resolve_device(device)
        self.cell, self.s, self.seed, self.dev, self.group = cell, s, seed, device, None
        self.kind = tr["step"]
        self.K, self.B = tr["steps_per_call"], tr["batch"]
        self.width = conf["model_config"]["sentence_length"] + 1
        self.rank, self.world = 0, 1
        self.captioner = build_captioner(s.model, COCOConfig(**conf["model_config"]), s.V)
        self.adam = dict(conf["adam"], learning_rate=tr["learning_rate"])
        a = self.adam
        self.opt = Adam(a["learning_rate"], b1=a["b1"], b2=a["b2"], eps=a["eps"],
                        clipvalue=a["clipvalue"])
        self.params0 = make_params(s, seed, device)
        self.stop = torch.zeros(s.V + 1, dtype=torch.bool)
        self.stop[inputs.FIRST_WORD:inputs.FIRST_WORD + tr.get("stop_words", 0)] = True
        self.multi = self._build()
        gen = inputs.generator(seed, 1, device)
        n = tr["pool_batches"]
        self.check_steps = 1 + self.K
        if n < self.check_steps:
            raise ValueError(f"a pool of {n} batches cannot give the check's "
                             f"{self.check_steps} steps rows that all differ")
        toks, _ = inputs.captions(n * self.B, tr["lengths"], s.V, self.width, gen)
        self.images = inputs.images(n * self.B, s.image, gen).reshape(n, self.B, s.image,
                                                                       s.image, 3)
        cap_in, y = inputs.training_batch(toks, self.width, s.V, device)
        self.cap_in = cap_in.reshape(n, self.B, self.width)
        self.y = y.reshape(n, self.B, self.width, s.V)
        self.mask_gen = inputs.generator(seed, 2, device)
        self.check_masks = [self._masks() for _ in range(self.check_steps)]
        # the first steps, through the window's call: one step, then K
        params, state, m1 = self.call(self.params0, self.opt.init(self.params0), [0],
                                      self.check_masks[:1])
        mu = {k: v / (1.0 - a["b1"]) for k, v in leaves(state["mu"])}
        self.g1 = {k: float(torch.linalg.vector_norm(v.double())) for k, v in mu.items()}
        params, state, m2 = self.call(params, state, list(range(1, self.check_steps)),
                                      self.check_masks[1:])
        p0 = dict(leaves(self.params0))
        self.delta = {k: float(torch.linalg.vector_norm((v - p0[k]).double()))
                      for k, v in leaves(params)}
        self.losses = [float(x) for x in torch.cat([m1["loss"], m2["loss"]]).cpu()]
        self.params, self.state = params, state
        # one more call of K steps, timed, places the traced stretch
        self.next = self.check_steps % n
        t = time.perf_counter()
        self._window_call()
        self._sync()
        call_s = time.perf_counter() - t
        first = math.ceil(train.TRACED_FROM_S / call_s)
        self.trace_calls = (first, first + max(1, round(train.TRACED_S / call_s)))
        self.traced_calls = 0

    def call(self, params, state, batches: list, masks: list):
        """One K-step call over the pool's ``batches``, its stacks gathered
        on the card from the pool's batches by index (views, then one copy
        each): nothing in it waits for the card, so the host queues the next
        call while the one before runs (``train.Entry.call`` copies the
        indices to the card, which waits for every queued call)."""
        stacks = [torch.stack([x[b] for b in batches]) for x in (self.images, self.cap_in,
                                                                 self.y)]
        pm = [train.program_masks(self.s.model, m) for m in masks]
        return self.multi(params, state, *stacks, None, masks=pm)

    def traced(self) -> dict:
        """What ran in the traced calls, and the device ms of each phase of
        the last step replayed (``multi.phase_ms``, read after the window:
        nothing in it waits on them); no counter where the program has no
        phase marks."""
        out = dict(super().traced(), kind="finetune_resnet")
        read = getattr(self.multi, "phase_ms", None)
        ms = read() if read is not None else None
        if ms:
            out["counters"] = {f"phase_ms.{p}": ms[p] for p in PHASES}
        return out

    def reference(self, tf32: bool = False, rows: slice = slice(None)) -> dict:
        """The reference's first 1 + K steps (``train.Entry.reference``'s
        contract) through ``reference.resnet``."""
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        a = self.adam
        opt = ref.Adam(a["learning_rate"], a["b1"], a["b2"], a["eps"], a["clipvalue"])
        p, st = self.params0, opt.init(self.params0)
        losses, g1 = [], None
        stop = self.stop.to(self.dev)
        for k in range(self.check_steps):
            x, c, y = self.images[k][rows], self.cap_in[k][rows], self.y[k][rows]
            m = mask_rows(self.check_masks[k], rows)
            p, st, loss, g = resnet.finetune_step(p, st, opt, x, c, y, m, self.s, stop,
                                                  inputs.SOS, inputs.EOS)
            losses.append(float(loss))
            if g1 is None:
                g1 = leaf_norms(g)
        p0 = dict(leaves(self.params0))
        delta = {k: float(torch.linalg.vector_norm((v - p0[k]).double())) for k, v in leaves(p)}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return {"losses": losses, "g1": g1, "delta": delta}
