"""PyTorch port: the LRP-inference fine-tune on a ResNet encoder, against the
benchmark's plain reference (``perfbench/reference/resnet.py``), on the CPU.

ResNet-101 at 32x32 (a 1x1x2048 grid) at its full channel widths, the
adaptive decoder at E = H = 32 over a vocabulary of 50, with the
benchmark's own weights (``perfbench/entries/finetune_resnet.py::
make_params``: glorot kernels, BatchNorm drawn and its statistics
calibrated, so that the BN rule is no identity). Both sides run in
float64: through 104 convs the walk's divisions and the gradients of the
early BN leaves amplify float32 rounding (1e-5 to 1e-3 of a leaf on some
seeds), in float64 they agree to ~1e-15 and the tolerances can be tight.

* ``lrp_weights`` takes its CNN side by encoder: the ResNet walk for
  ResNet-50/101 against the reference's; the VGG path unchanged, bit for
  bit, against its previous call sequence; any other encoder a
  ``ValueError`` that names the supported ones;
* one 1 + K-step fine-tune call (a call of one step, then one of K =
  2, through ``make_multi_lrp_finetune_step``) against the reference's
  steps: the losses, the first clipped gradient and the change;
* the walk's spans ``lrpic.resnet_walk.forward`` and ``.rules``: one
  each a walk (``lrp_weights`` walks its batch at once, the Explainer an
  image at a time), the rules after their forward, inside the Explainer's
  ``lrpic.explain.cnn``, no name holding another, no node in a
  ``make_fx`` trace; the phase marks read nothing on the CPU.

On a card (``TestOnCard``, marked ``cuda``; it skips here): the captured
K-step call equals its eager chain of single steps under deterministic
cuDNN, and the phase marks recorded inside the captured step sum to
within 5 % of a step's CUDA-event time.

This file imports no JAX: the card's machine runs it with ``--noconftest``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from lrp_imagecaptioning_torch.config import COCOConfig, FlickrConfig  # noqa: E402
from lrp_imagecaptioning_torch.explain.cnn_lrp import vgg_lrp_preset_a_wordbatched  # noqa: E402
from lrp_imagecaptioning_torch.explain.decoder_lrp import explain_word_adaptive  # noqa: E402
from lrp_imagecaptioning_torch.explain.engine import Explainer  # noqa: E402
from lrp_imagecaptioning_torch.explain.resnet_lrp import resnet_lrp_wordbatched  # noqa: E402
from lrp_imagecaptioning_torch.models.adaptive import DropoutMasks  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner  # noqa: E402
from lrp_imagecaptioning_torch.train import lrp_finetune as ft  # noqa: E402
from lrp_imagecaptioning_torch.train.optimizer import Adam  # noqa: E402
from lrp_imagecaptioning_torch.weights import tree_map  # noqa: E402
from perfbench.entries.finetune_resnet import make_params  # noqa: E402
from perfbench.harness import inputs  # noqa: E402
from perfbench.reference import resnet as ref  # noqa: E402
from perfbench.reference import steps as ref_steps  # noqa: E402
from perfbench.reference.model import Sizes, draw_masks, leaves  # noqa: E402

torch.set_num_threads(2)

V, E, T = 50, 32, 6            # T: the teacher-forced positions (sentence_length + 1)
SIZES = Sizes("adaptiveattention", "resnet101", "activation_49", E, E, 1, 2048, V, 32)
ADAM = dict(learning_rate=1e-6, b1=0.9, b2=0.999, eps=1e-8, clipvalue=0.1)
_CACHE = {}


def config(**over):
    kw = dict(img_encoder="resnet101", layer_name="activation_49", img_feature_length=1,
              img_feature_dim=2048, embedding_dim=E, hidden_dim=E, sentence_length=T - 1)
    return COCOConfig(**dict(kw, **over))


def setup(dtype=torch.float64, device="cpu", sizes=SIZES, batch=2, seed=7):
    """(captioner, params, images, captions_in, y, stop table) from the
    benchmark's draws: three batches of ``batch`` rows."""
    key = (dtype, device, sizes, batch, seed)
    if key not in _CACHE:
        dev = torch.device(device)
        params = tree_map(lambda t: t.to(dtype), make_params(sizes, seed, dev))
        gen = inputs.generator(seed, 1, dev)
        toks, _ = inputs.captions(3 * batch, dict(mean=3, std=1, min=1, max=T - 1), V, T, gen)
        images = inputs.images(3 * batch, sizes.image, gen).to(dtype)
        cap_in, y = inputs.training_batch(toks, T, V, dev)
        stop = torch.zeros(V + 1, dtype=torch.bool)
        stop[inputs.FIRST_WORD:inputs.FIRST_WORD + 5] = True
        cap = build_captioner("adaptiveattention", config(img_encoder=sizes.arch,
                                                          img_feature_length=sizes.L,
                                                          image_size=(sizes.image,) * 2), V)
        shape = (3, batch)
        _CACHE[key] = (cap, params, images.reshape(*shape, *images.shape[1:]),
                       cap_in.reshape(*shape, T), y.to(dtype).reshape(*shape, T, V), stop)
    return _CACHE[key]


def test_resnet_lrp_weights_matches_reference():
    cap, params, images, cap_in, _, stop = setup()
    x, c = images[0], cap_in[0]
    logits = cap.forward_train(params, x, c, None)
    got = ft.lrp_weights(cap, params, x, logits, stop, inputs.SOS, inputs.EOS, "mean")
    want = ref.relevance_weights(params, x, c, SIZES, stop, inputs.SOS, inputs.EOS)
    scored = want != 1
    assert scored.any() and torch.equal(got != 1, scored)
    scale = (want - 1).abs().max()
    assert (got - want).abs().max() <= 1e-10 * scale, (got - want).abs().max() / scale


def test_finetune_call_matches_reference():
    """A call of one step, then a call of K = 2 (the benchmark's check),
    against the reference's three steps from the same weights, batches and
    dropout masks."""
    cap, params0, images, cap_in, y, stop = setup()
    opt = Adam(ADAM["learning_rate"], b1=ADAM["b1"], b2=ADAM["b2"], eps=ADAM["eps"],
               clipvalue=ADAM["clipvalue"])
    multi = ft.make_multi_lrp_finetune_step(cap, opt, stop.numpy(), inputs.SOS, inputs.EOS,
                                            "mean", donate=False)
    gen = inputs.generator(3, 2, torch.device("cpu"))
    masks = [tree_map(lambda t: t.double(), draw_masks(SIZES, 2, 0.5, gen, "cpu"))
             for _ in range(3)]
    program = [DropoutMasks(m["v_feat"], m["global_feat"], m["out"], m["logit"], m["lstm"])
               for m in masks]
    p, st, m1 = multi(params0, opt.init(params0), images[:1], cap_in[:1], y[:1], None,
                      masks=program[:1])
    g1 = dict(leaves(st["mu"]))
    p, st, m2 = multi(p, st, images[1:], cap_in[1:], y[1:], None, masks=program[1:])
    losses = torch.cat([m1["loss"], m2["loss"]])

    ropt = ref_steps.Adam(ADAM["learning_rate"], ADAM["b1"], ADAM["b2"], ADAM["eps"],
                          ADAM["clipvalue"])
    q, rst, want_losses, want_g1 = params0, ropt.init(params0), [], None
    for k in range(3):
        q, rst, loss, g = ref.finetune_step(q, rst, ropt, images[k], cap_in[k], y[k], masks[k],
                                            SIZES, stop, inputs.SOS, inputs.EOS)
        want_losses.append(float(loss))
        want_g1 = want_g1 or dict(leaves(g))
    # the program's Adam rounds beta and its bias corrections to float32
    # (2.4e-7 of 1 - beta1; one ulp of beta2 ** 2 is 3e-5 of 1 - beta2 ** 2),
    # the reference's powers stay in float64: the first step's loss agrees
    # to rounding, the later steps' and the change to those
    np.testing.assert_allclose(losses[0].item(), want_losses[0], rtol=1e-12)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-6)
    for k, g in want_g1.items():
        got = g1[k] / (1 - ADAM["b1"])
        assert (got - g).abs().max() <= 1e-6 * float(g.abs().max()), k
    # a weight whose gradient is 0 on the first steps (a unit off at every
    # sampled position) may wake on a later one on either side alone, the
    # params having moved by those roundings: by the leaf's norm (the
    # benchmark's measure) to 1e-4, by the element to 2 % of the leaf's most
    moved = dict(leaves(q))
    p0 = dict(leaves(params0))
    for k, v in leaves(p):
        want = moved[k] - p0[k]
        got = v - p0[k]
        gap = abs(float(got.norm()) - float(want.norm()))
        assert gap <= 1e-4 * float(want.norm()), k
        assert (got - want).abs().max() <= 2e-2 * float(want.abs().max()), k


def old_cnn_scores(captioner, params, images, y_pred_logits, stop_table, mode):
    """``lrp_weights`` as it called the VGG walk before it took its CNN side
    by encoder."""
    cfg = captioner.cfg
    B, T_, V_ = y_pred_logits.shape
    caption1 = y_pred_logits.argmax(dim=-1) + 1
    prev = torch.cat([torch.full((B, 1), inputs.SOS, dtype=torch.long), caption1[:, :-1]], 1)
    feat_grid = captioner.encode(params, images)
    consts = captioner.prepare_consts(params, feat_grid)
    caches = captioner.decoder.forward_cached_from_inputs(
        params["decoder"], consts, torch.clamp(prev - 1, min=0), cfg.hidden_dim)
    is_stop = torch.as_tensor(stop_table, dtype=torch.bool)[caption1]
    seen_eos = torch.cumsum((caption1 == inputs.EOS).int(), dim=1) > 0
    valid = ~is_stop & ~seen_eos
    words0 = torch.clamp(caption1 - 1, min=0)
    pos = torch.arange(T_).expand(B, T_)
    r_feat, _, _ = explain_word_adaptive(params["decoder"], consts, caches, words0.gather(1, pos),
                                         positions=pos)
    g = int(round(math.sqrt(cfg.img_feature_length)))
    seeds = r_feat.reshape(B, T_, g, g, cfg.img_feature_dim)
    scores_w = torch.stack([
        ft._score(ft._project(vgg_lrp_preset_a_wordbatched(
            params["vgg"], images[b:b + 1], seeds[b], cfg.img_encoder,
            cfg.layer_name).mean(dim=-1)), mode)
        for b in range(B)])
    scores_w = torch.where(valid, scores_w, torch.zeros_like(scores_w))
    scores = torch.zeros((B, T_), dtype=scores_w.dtype).scatter_add_(1, pos, scores_w)
    onehot = torch.nn.functional.one_hot(words0, V_).to(scores.dtype)
    return 1.0 + onehot * scores[:, :, None]


@pytest.mark.parametrize("arch, until", [("vgg16", "block2_conv2"), ("vgg19", "block3_conv4")])
@pytest.mark.parametrize("mode", ["mean", "quantile"])
def test_vgg_lrp_weights_unchanged(arch, until, mode):
    L, D = {"block2_conv2": (16, 128), "block3_conv4": (16, 256)}[until]
    cfg = FlickrConfig(img_encoder=arch, layer_name=until, img_feature_length=L,
                       img_feature_dim=D, embedding_dim=16, hidden_dim=16, sentence_length=T - 1)
    cap = build_captioner("adaptiveattention", cfg, V)
    params = cap.init_params(0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    images = torch.randn(2, 8 if arch == "vgg16" else 16, 8 if arch == "vgg16" else 16, 3,
                         generator=gen) * 30
    cap_in = torch.randint(0, V, (2, T), generator=gen)
    logits = cap.forward_train(params, images, cap_in, None)
    stop = np.zeros(V + 1, bool)
    stop[5:9] = True
    got = ft.lrp_weights(cap, params, images, logits, stop, inputs.SOS, inputs.EOS, mode)
    want = old_cnn_scores(cap, params, images, logits, stop, mode)
    assert (want != 1).any() and torch.equal(got, want)


@pytest.mark.parametrize("where", ["make_lrp_finetune_step", "make_multi_lrp_finetune_step",
                                   "lrp_weights"])
def test_an_encoder_without_a_walk_raises(where):
    cfg = config(img_encoder="inception_v3", layer_name="mixed10")
    cap = build_captioner("adaptiveattention", cfg, V)
    stop = np.zeros(V + 1, bool)
    opt = Adam(1e-6)
    with pytest.raises(ValueError, match="resnet101") as err:
        if where == "lrp_weights":
            ft.lrp_weights(cap, {"vgg": {}, "decoder": {}}, torch.zeros(1, 75, 75, 3),
                           torch.zeros(1, T, V), stop, inputs.SOS, inputs.EOS)
        else:
            getattr(ft, where)(cap, opt, stop, inputs.SOS, inputs.EOS)
    for name in ft.CNN_WALKS:
        assert name in str(err.value)
    assert "inception_v3" in str(err.value)


def spans(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("lrpic.") and "CUDA" not in str(e.device_type())]


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


class PP:
    SOS_TOKEN, EOS_TOKEN = "szeros", "zeros"
    SOS_TOKEN_LABEL_ENCODED, EOS_TOKEN_LABEL_ENCODED = inputs.SOS, inputs.EOS
    word_of = {i: f"w{i}" for i in range(1, V + 1)}


def test_walk_spans_nest_in_lrp_weights_and_the_explainer():
    cap, params, images, cap_in, _, stop = setup(torch.float32)
    x = images[0]
    logits = cap.forward_train(params, x, cap_in[0], None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ft.lrp_weights(cap, params, x, logits, stop, inputs.SOS, inputs.EOS)
    found = spans(prof)
    fwd = [s for s in found if s[0] == "lrpic.resnet_walk.forward"]
    rules = [s for s in found if s[0] == "lrpic.resnet_walk.rules"]
    # lrp_weights walks the batch's images at once: one forward, then its rules
    assert len(fwd) == len(rules) == 1 and len(found) == 2
    assert fwd[0][2] <= rules[0][1]

    ex = Explainer(cap, params, PP(), "lrp", batch_size=2, word_buckets=(T - 1,), device="cpu")
    toks = np.array([[5, 7, 2, 0, 0], [8, 9, 6, 2, 0]], np.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.analyze_many(x, toks)
    found = spans(prof)
    cnn = [s for s in found if s[0] == "lrpic.explain.cnn"]
    walk = [s for s in found if s[0].startswith("lrpic.resnet_walk.")]
    assert cnn and len(walk) == 2 * x.shape[0]
    assert all(any(inside(w, c) for c in cnn) for w in walk)
    names = {s[0] for s in found}
    assert not [(a, b) for a in names for b in names if a != b and a in b]


def test_walk_leaves_no_node_in_a_make_fx_trace():
    from torch.fx.experimental.proxy_tensor import make_fx

    _, params, images, _, _, _ = setup(torch.float32)
    enc = params["vgg"]
    seeds = torch.randn(3, 1, 1, 2048)
    traced = make_fx(lambda p, x, s: resnet_lrp_wordbatched(p, x, s, "resnet101"),
                     tracing_mode="fake")(enc, images[0][:1], seeds)
    assert [str(n.target) for n in traced.graph.nodes
            if "profiler" in str(n.target) or "record_function" in str(n.target)] == []


def test_phase_marks_read_nothing_on_the_cpu():
    cap, params, images, cap_in, y, stop = setup()
    opt = Adam(1e-6)
    step = ft.make_lrp_finetune_step(cap, opt, stop.numpy(), inputs.SOS, inputs.EOS,
                                     donate=False)
    multi = ft.make_multi_lrp_finetune_step(cap, opt, stop.numpy(), inputs.SOS, inputs.EOS)
    assert step.marks.ms() is None and multi.phase_ms() is None
    step(params, opt.init(params), images[0], cap_in[0], y[0], torch.Generator().manual_seed(0))
    assert step.marks.ms() is None and ft.PhaseMarks.PHASES == ("predict", "lrp_weights",
                                                                 "update")


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the captured step and its events exist only there")

    def test_captured_call_equals_eager_chain_and_phases_sum_to_the_step(self):
        """ResNet-101 at 112x112 (a 4x4 grid), batch 2, f32: the K-step
        call's replays against the same steps run eagerly (``step.dual``
        and Adam, as the captured body), bit for bit under deterministic
        cuDNN; then one replay's device ms, by CUDA events around it,
        against the phase marks it recorded."""
        from lrp_imagecaptioning_torch.runtime import resolve_device
        from lrp_imagecaptioning_torch.train.step import graph_body

        dev = resolve_device("cuda")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        sizes = Sizes("adaptiveattention", "resnet101", "activation_49", E, E, 16, 2048, V, 112)
        cap, params0, images, cap_in, y, stop = setup(torch.float32, "cuda", sizes)
        opt = Adam(1e-4, clipvalue=0.1)
        multi = ft.make_multi_lrp_finetune_step(cap, opt, stop.numpy(), inputs.SOS, inputs.EOS,
                                                donate=False)
        gen = inputs.generator(3, 2, dev)
        masks = [draw_masks(sizes, 2, 0.5, gen, dev) for _ in range(3)]
        program = [DropoutMasks(m["v_feat"], m["global_feat"], m["out"], m["logit"], m["lstm"])
                   for m in masks]
        state0 = opt.init(params0)
        p, st, m = multi(params0, state0, images, cap_in, y, None, masks=program)
        torch.cuda.synchronize()

        single = ft.make_lrp_finetune_step(cap, opt, stop.numpy(), inputs.SOS, inputs.EOS,
                                           donate=False)
        body = graph_body(opt, single.dual)
        q, mu, nu = params0, state0["mu"], state0["nu"]
        losses = []
        for k in range(3):
            scalars = torch.stack(opt.step_scalars(k + 1, state0["learning_rate"])).to(dev)
            q, mu, nu, mk = body(q, mu, nu, scalars, images[k], cap_in[k], y[k], program[k])
            losses.append(mk["loss"])
        assert torch.equal(m["loss"], torch.stack(losses))
        for (k, a), (_, b) in zip(leaves(p), leaves(q)):
            assert torch.equal(a, b), k

        # one replay timed by CUDA events around it, a sleep queued first so
        # that the card is busy while the host launches the replay (a
        # captured step's launch takes the host milliseconds)
        multi(p, st, *(x[:1] for x in (images, cap_in, y)), None, masks=program[:1])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        multi.graph.graph.replay()
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end)
        phases = multi.phase_ms()
        assert set(phases) == {"predict", "lrp_weights", "update"}
        assert all(v > 0 for v in phases.values()), phases
        assert abs(sum(phases.values()) - step_ms) <= 0.05 * step_ms, (phases, step_ms)
