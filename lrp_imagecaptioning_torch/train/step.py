"""Train and eval steps, on one device and over a mesh.

One step: the teacher-forced forward with dropout, the loss, its gradient
by autograd (through the ``lstm_gates`` kernel's Function on the card), the
clipped Adam update.

Params and optimizer state are plain dicts of tensors; a step returns new
ones and leaves its arguments as they were. ``donate`` (the JAX package's
buffer donation) is True by default: a K-step call on the card then returns
its graph's own tensors, rewritten by its next call; ``donate=False``
returns state that aliases no tensor of the caller's or of the runner's.

K steps a call (``make_multi_train_step``, ``make_sharded_multi_train_step``;
the JAX package's ``lax.scan`` over K stacked batches, ``--steps-per-call``)
compute what K chained steps compute. On the card each step is the replay
of one captured step (``graphs.StepGraph``), its dropout drawn before the
replays in the single steps' order and Adam's scalars read from the card;
the state handed in is the state updated (the runner's own, rewritten by
its next call). A sharded call chains the sharded steps; a mesh of one
slot in one process (``one_device_mesh``: a 1-rank NCCL group too) takes
the one-device call instead. ``run_stepped_steps`` feeds stacks of K and
runs the ragged rest as single steps.

The sharded step (``make_sharded_train_step``) computes what the one-device
step computes on the global batch, as the JAX package's GSPMD program does,
up to the order of the sums:

* dropout: the masks of the global batch come from the one generator, and
  each data slot takes its rows (every process of a group seeds the same
  generator and keeps its own rows);
* the loss is a mean over the rows, so each slot's loss and gradient are
  weighted by its rows over the global batch before the sum (and the
  ``all_reduce`` across processes);
* the element-wise clip and Adam run once, on the summed gradient (a clip
  of each slot's gradient before the sum would be another step);
* the accuracy is a ratio of sums: its numerator and denominator are
  summed apart.

Each slot runs its forward and backward on its own device, and the host
issues the slots one after the other from the caller's thread
(``run_slots``). The train step is bound by that issue, so on several
cards a step takes longer as slots are added; a host thread a slot was
slower still (PERF.md, ``scripts/slot_issue_timing.py``). The slots'
gradients are summed, in slot order, on the first slot's device, where
the update is applied.

With ``shard_vocab`` a data row's model slots hold slices of the
vocabulary (``parallel.place_params``): the embedding's slices are
gathered for the lookup, the decoder runs with its output layer replaced by
the identity (its forward then returns the pre-logit features), each model
slot computes its slice of the logits, and the softmax-CE takes its
logsumexp across the slices; each slice's gradient and Adam moments stay on
its slot.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models.captioner import keras_categorical_ce, masked_accuracy, masked_accuracy_counts
from ..parallel.distributed import all_reduce_sum
from ..parallel.mesh import Sharded, VocabSlices, as_sharded, as_stacked, place_params
from ..weights import check_tree_like, tree_leaves, tree_map, tree_unflatten
from .optimizer import apply_updates


def value_and_grad(loss_of_params, params):
    """(loss, aux, grads): ``loss_of_params(p) -> (scalar, aux)`` on copies
    of ``params`` that require grad; grads in ``params``' structure."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, aux = loss_of_params(p)
        grads = torch.autograd.grad(loss, tree_leaves(p), materialize_grads=True)
    return loss.detach(), aux, tree_unflatten(params, grads)


def train_grads(captioner):
    """-> ``grads(params, images, captions_in, y_onehot, masks,
    generator=None) -> (loss, {"accuracy"}, grads)``: the teacher-forced
    loss with dropout (``masks``, or drawn from ``generator``) and its
    gradient, the train step before its optimizer update."""
    loss_fn = captioner.loss_fn()

    def grads(params, images, captions_in, y_onehot, masks, generator=None):
        def loss(p):
            logits = captioner.forward_train(p, images, captions_in, generator, masks=masks)
            return loss_fn(logits, y_onehot), logits.detach()

        loss_value, logits, g = value_and_grad(loss, params)
        return loss_value, {"accuracy": masked_accuracy(logits, y_onehot)}, g

    return grads


def undonated(step, donate: bool):
    """``step`` itself, or with ``donate=False`` a step whose returned params
    and optimizer state share no storage with its arguments (copies where
    they would) nor with a graph runner's buffers (``always_copy``)."""
    if donate:
        return step
    always_copy = hasattr(step, "graph")

    def call(params, opt_state, *args, **kwargs):
        held = {t.untyped_storage().data_ptr() for t in tree_leaves((params, opt_state))
                if isinstance(t, torch.Tensor)}
        new_params, new_state, metrics = step(params, opt_state, *args, **kwargs)

        def own(t):
            if isinstance(t, torch.Tensor) and (always_copy
                                                or t.untyped_storage().data_ptr() in held):
                return t.clone()
            return t

        return tree_map(own, new_params), tree_map(own, new_state), metrics

    for k, v in vars(step).items():
        setattr(call, k, v)
    return call


def make_train_step(captioner, optimizer, donate: bool = True):
    """-> step(params, opt_state, images, captions_in, y_onehot, generator,
    masks=None) -> (params, opt_state, metrics): loss -> grad -> optimizer
    update. ``generator`` (a ``torch.Generator`` on the params' device)
    draws the dropout masks; None runs without dropout; ``masks`` (the
    decoder's ``DropoutMasks``) replace the draw. ``donate``: the module's
    docstring."""
    grads_of = train_grads(captioner)

    def step(params, opt_state, images, captions_in, y_onehot, generator, masks=None):
        loss, metrics, grads = grads_of(params, images, captions_in, y_onehot, masks, generator)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, dict(metrics, loss=loss)

    return undonated(step, donate)


def graph_body(optimizer, grads_of):
    """The body of a ``graphs.StepGraph``: ``grads_of(params, *batch,
    masks) -> (loss, metrics, grads)`` (``train_grads``'s, the fine-tune's)
    then Adam from the step's scalars on the card (``Adam.moments``, the
    arithmetic of ``Adam.update``)."""
    def body(params, mu, nu, scalars, *batch_and_masks):
        loss, metrics, grads = grads_of(params, *batch_and_masks)
        updates, mu, nu = optimizer.moments(grads, mu, nu, *scalars)
        return apply_updates(params, updates), mu, nu, dict(metrics, loss=loss)

    return body


def chain_steps(step, params, opt_state, stacks, generator, masks=None):
    """K chained calls of ``step`` over (K, ...) batch ``stacks`` (each step
    drawing its dropout from ``generator``, or taking ``masks[k]``), the
    metrics (K,)-stacked: what a K-step call computes, as single steps."""
    out = []
    for k in range(len(stacks[0])):
        params, opt_state, m = step(params, opt_state, *(x[k] for x in stacks), generator,
                                    masks=None if masks is None else masks[k])
        out.append(m)
    return params, opt_state, {key: torch.stack([torch.as_tensor(m[key]) for m in out])
                               for key in ("loss", "accuracy")}


def drawn_masks(captioner, params, batch: int, K: int, generator, masks=None):
    """The dropout masks of K steps over ``batch`` rows: ``masks`` when given,
    else drawn from ``generator`` step by step, as K single steps draw them;
    None where there is no dropout."""
    if masks is None:
        masks = [global_masks(captioner, params, batch, generator) for _ in range(K)]
    return None if masks[0] is None else list(masks)


def make_multi_train_step(captioner, optimizer, donate: bool = True):
    """K optimizer steps a call over K stacked batches, the JAX package's
    ``make_multi_train_step``: -> ``multi(params, opt_state, images (K, B,
    H, W, 3), captions_in (K, B, T), y_onehot (K, B, T, V), generator,
    masks=None) -> (params, opt_state, metrics (K,)-stacked)``, the same as
    K chained single steps (``make_train_step``).

    On the card each step is the replay of one captured step
    (``graphs.StepGraph``, ``multi.graph``): K dependent steps cost the
    host K replays instead of K Python steps. The dropout masks are drawn
    from ``generator`` step by step before the replays, in the single
    steps' order, or taken from ``masks`` (a list of K). The returned state
    is the runner's own, rewritten by its next call, unless ``donate`` is
    False. On the CPU the call is the loop of single steps."""
    from ..graphs import StepGraph

    single = make_train_step(captioner, optimizer)
    graph = StepGraph(graph_body(optimizer, train_grads(captioner)), optimizer)

    def multi(params, opt_state, images, captions_in, y_onehot, generator, masks=None):
        stacks = (images, captions_in, y_onehot)
        if images.device.type != "cuda":
            return chain_steps(single, params, opt_state, stacks, generator, masks)
        masks = drawn_masks(captioner, params, images.shape[1], images.shape[0], generator,
                            masks)
        return graph(params, opt_state, stacks, masks)

    multi.graph = graph
    return undonated(multi, donate)


def metric_accumulator(keys=("loss", "accuracy")):
    """``record(m)`` keeps each call's metric sums on the device (no host sync
    a step); ``finalize(steps)`` reads them once and returns host floats
    averaged over ``steps``."""
    acc = {k: [] for k in keys}

    def record(m):
        for k in acc:
            acc[k].append(m[k].sum())

    def finalize(steps):
        return {k: (float(torch.stack(vs).sum()) if vs else 0.0) / max(steps, 1)
                for k, vs in acc.items()}

    return record, finalize


def run_stepped_steps(generator, steps, K, place, dropout_gen, multi_fn, single_fn, params,
                      opt_state, record, place_stacked=None):
    """Pulls ``steps`` batches ``((captions_in, images), y_onehot)`` from the
    batch iterator ``generator`` and runs them in order: ``multi_fn`` on
    stacks of ``K`` (the JAX package's ``steps_per_call``), ``single_fn`` on
    the ragged tail and on a K-group holding a batch of another size (a
    short epoch-tail batch cannot stack with full ones). ``place(arr)``
    moves a host array to the device, ``place_stacked`` a (K, B, ...) stack
    (default ``place``; on a mesh it splits axis 1); ``dropout_gen``, a
    ``torch.Generator`` (or None: no dropout), draws every step's dropout
    where the JAX package's ``split_rng`` hands out keys; ``record(metrics)``
    takes each call's metrics, (K,)-stacked from ``multi_fn``. Returns the
    updated (params, opt_state)."""
    if dropout_gen is not None and not isinstance(dropout_gen, torch.Generator):
        raise TypeError("dropout_gen must be a torch.Generator or None, got "
                        f"{type(dropout_gen).__name__}")
    if place_stacked is None:
        place_stacked = place
    done = 0
    while done < steps:
        if K > 1 and steps - done >= K:
            group = [next(generator) for _ in range(K)]
            if len({b[0][1].shape[0] for b in group}) == 1:
                stacked = [place_stacked(np.stack(a)) for a in (
                    [b[0][1] for b in group], [b[0][0] for b in group], [b[1] for b in group])]
                params, opt_state, m = multi_fn(params, opt_state, *stacked, dropout_gen)
                record(m)
                done += K
                continue
        else:
            group = [next(generator)]
        for (cap_in, imgs), y in group:
            params, opt_state, m = single_fn(params, opt_state, place(imgs), place(cap_in),
                                             place(y), dropout_gen)
            record(m)
            done += 1
    return params, opt_state


def make_eval_step(captioner):
    """-> eval_step(params, images, captions_in, y_onehot) -> metrics, without
    dropout and without a gradient."""
    loss_fn = captioner.loss_fn()

    @torch.no_grad()
    def eval_step(params, images, captions_in, y_onehot):
        logits = captioner.forward_train(params, images, captions_in, None)
        return {"loss": loss_fn(logits, y_onehot), "accuracy": masked_accuracy(logits, y_onehot)}

    return eval_step


# -- over a mesh ---------------------------------------------------------------


def on_device(dev: torch.device):
    """The context that makes ``dev`` the current card (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def run_slots(mesh, fn) -> list:
    """``fn(i)`` for each data row ``i`` of ``mesh`` in turn, with its slot's
    device current; the results in row order."""
    out = []
    for i, dev in enumerate(mesh.slots):
        with on_device(dev):
            out.append(fn(i))
    return out


def replicas(mesh, params) -> list:
    """A replica of ``params`` for each data row of ``mesh``: on the row's
    first device, a list of vocabulary slices (``shard_vocab``) slice j on
    the row's model slot j; the tensors themselves where the device already
    holds them."""
    def on_row(node, row):
        if isinstance(node, dict):
            return {k: on_row(v, row) for k, v in node.items()}
        if isinstance(node, VocabSlices):
            return VocabSlices(t.to(d) for t, d in zip(node, row))
        if isinstance(node, (list, tuple)):
            return type(node)(on_row(v, row) for v in node)
        return node.to(row[0])

    return [on_row(params, row) for row in mesh.devices]


def mask_rows(masks, rows: slice, device):
    """Rows ``rows`` of a global batch's dropout masks (a decoder's
    ``DropoutMasks`` NamedTuple) on ``device``: the batch axis is each
    field's first, the LSTM masks' (4, B, ...) second."""
    def take(x, axis):
        if isinstance(x, tuple):
            return tuple(take(v, axis) for v in x)
        return (x[rows] if axis == 0 else x[:, rows]).to(device)

    return type(masks)(*(take(v, 1 if name == "lstm" else 0)
                         for name, v in zip(masks._fields, masks)))


def global_masks(captioner, params, batch: int, generator, masks=None):
    """The dropout masks of one training forward over the global batch:
    ``masks`` when given, else drawn from ``generator`` as the one-device
    forward draws them (None without a generator or at rate 0)."""
    rate = captioner.cfg.drop_rate
    if masks is None and generator is not None and rate > 0.0:
        dec = params["decoder"]
        # the draw reads the embedding's and the output layer's shapes alone
        shapes = {"embedding": _whole(dec["embedding"], 0),
                  "output": {"kernel": _whole(dec["output"]["kernel"], 1)}}
        masks = captioner.decoder.draw_dropout_masks(generator, shapes, batch, captioner.cfg,
                                                     rate)
    return masks


def _whole(x, dim: int) -> torch.Tensor:
    """A tensor of the whole shape of ``x``, or of its vocabulary slices
    joined on ``dim``, with no storage."""
    if not isinstance(x, VocabSlices):
        return torch.empty(x.shape, device="meta")
    shape = list(x[0].shape)
    shape[dim] = sum(t.shape[dim] for t in x)
    return torch.empty(shape, device="meta")


def sharded_batch(mesh, images, captions_in, y_onehot):
    """The three batch arrays as ``Sharded`` row slices over the mesh's
    slots, the captions as int64 embedding indices."""
    images, captions_in, y_onehot = (as_sharded(mesh, a) for a in (images, captions_in, y_onehot))
    return images, captions_in._replace(shards=[c.long() for c in captions_in.shards]), y_onehot


def sharded_value_and_grad(mesh, reps, slot_loss):
    """``slot_loss(i, params) -> (loss, (correct, valid))`` on each data row
    ``i`` with its replica ``reps[i]`` (``run_slots``); the loss is the
    row's share of the global mean. Returns (loss, accuracy, grads) summed
    over the rows (in row order, each gradient leaf on the device of its
    leaf in ``reps[0]``: the first slot's, or its vocabulary slice's) and
    over the processes."""
    primary = mesh.primary
    targets = [leaf.device for leaf in tree_leaves(reps[0])]

    def slot(i):
        loss, (correct, valid), grads = value_and_grad(lambda q: slot_loss(i, q), reps[i])
        parts = {primary: [torch.stack([loss, correct, valid]).to(primary)]}
        for g, target in zip(tree_leaves(grads), targets):
            parts.setdefault(target, []).append(g.reshape(-1).to(target))
        return {d: torch.cat(v) for d, v in parts.items()}

    total = None
    for flat in run_slots(mesh, slot):
        total = flat if total is None else {d: total[d] + flat[d] for d in total}
    total = {d: all_reduce_sum(v, mesh) for d, v in total.items()}
    loss, correct, valid = total[primary][:3]
    start = dict.fromkeys(total, 0)
    start[primary] = 3
    leaves = []
    for g, target in zip(tree_leaves(reps[0]), targets):
        leaves.append(total[target][start[target]:start[target] + g.numel()].view(g.shape))
        start[target] += g.numel()
    return loss, correct / valid.clamp(min=1), tree_unflatten(reps[0], leaves)


def place_on_mesh(mesh, shard_vocab: bool = False, params_template=None,
                  opt_state_template=None):
    """-> ``place_state(params, opt_state)``: both where a sharded step keeps
    them (``parallel.place_params``: the mesh's first slot, with
    ``shard_vocab`` the vocabulary slices on the first row's model slots,
    Adam's moments as their params); the other rows take replicas a step.
    The layout follows from the mesh; ``params_template`` /
    ``opt_state_template`` (the JAX package's layout templates), where
    given, must have the placed trees' structure (``ValueError``)."""
    def place_state(params, opt_state):
        if params_template is not None:
            check_tree_like(params, params_template, "params")
        if opt_state_template is not None:
            check_tree_like(opt_state, opt_state_template, "opt_state")
        return place_params(mesh, params, shard_vocab), dict(
            opt_state, mu=place_params(mesh, opt_state["mu"], shard_vocab),
            nu=place_params(mesh, opt_state["nu"], shard_vocab))

    return place_state


def vocab_sharded_forward(captioner, params, images, captions_in, masks, row):
    """The teacher-forced logits of ``params`` whose embedding and output
    projection are vocabulary slices on the devices of ``row``: a list of
    (B, T, V_j) logits, slice j on ``row[j]``. The decoder runs on
    ``row[0]`` with the embedding gathered and its output layer the identity,
    so that its "logits" are the features the output layer takes (with the
    output dropout applied); each slot multiplies them by its slice, adds its
    bias and applies its columns of the logits' dropout."""
    dec = params["decoder"]
    kernels, biases = dec["output"]["kernel"], dec["output"]["bias"]
    H, dev = kernels[0].shape[0], row[0]
    trunk = dict(params, decoder=dict(
        dec, embedding=torch.cat([e.to(dev) for e in dec["embedding"]]),
        output={"kernel": torch.eye(H, device=dev), "bias": torch.zeros(H, device=dev)}))
    trunk_masks = None if masks is None else masks._replace(
        logit=torch.ones((images.shape[0], H), device=dev))
    feats = captioner.forward_train(trunk, images, captions_in, None, masks=trunk_masks)
    out, start = [], 0
    for k, b, d in zip(kernels, biases, row):
        logits = feats.to(d) @ k + b
        if masks is not None:
            logits = logits * masks.logit[:, None, start:start + k.shape[1]].to(d)
        out.append(logits)
        start += k.shape[1]
    return out


def vocab_sharded_loss(captioner, logits, y_onehot):
    """``captioner.loss_fn()`` and the accuracy's counts over logits split on
    the vocabulary (``vocab_sharded_forward``), ``y_onehot`` whole on the
    first slice's device: (loss, (correct, valid)), each on that device."""
    dev = logits[0].device
    ys, start = [], 0
    for z in logits:
        ys.append(y_onehot[..., start:start + z.shape[-1]].to(z.device, z.dtype))
        start += z.shape[-1]
    if captioner.loss_fn() is keras_categorical_ce:
        # Keras' CE on raw logits: the output over its sum, clipped (captioner.py)
        eps = 1e-7
        s = sum(z.sum(-1, keepdim=True).to(dev) for z in logits)
        s = s + torch.where(s >= 0, torch.full_like(s, eps), torch.full_like(s, -eps))
        loss = -sum((y * torch.log(torch.clamp(z / s.to(z.device), eps, 1.0 - eps))).sum(-1)
                    .to(dev) for z, y in zip(logits, ys)).mean()
    else:
        # softmax-CE, last step discarded: -(y . z) + logsumexp(z) sum(y)
        lse = torch.logsumexp(torch.stack([torch.logsumexp(z[:, :-1], -1).to(dev)
                                           for z in logits]), 0)
        dot = sum((y[:, :-1] * z[:, :-1]).sum(-1).to(dev) for z, y in zip(logits, ys))
        mass = sum(y[:, :-1].sum(-1).to(dev) for y in ys)
        loss = (lse * mass - dot).mean()
    # argmax over the slices: each slice's largest, the first slice of the largest
    best, where, offset = [], [], 0
    for z in logits:
        v, i = z[:, :-1].detach().max(-1)
        best.append(v.to(dev))
        where.append(i.to(dev) + offset)
        offset += z.shape[-1]
    pick = torch.stack(best).argmax(0, keepdim=True)
    pred = torch.stack(where).gather(0, pick)[0]
    y = y_onehot[:, :-1].to(dev)
    valid = y.sum(-1) > 0
    correct = (pred == y.argmax(-1)) & valid
    return loss, (correct.sum().float(), valid.sum().float())


def sharded_train_grads(captioner, mesh, shard_vocab: bool = False):
    """-> ``grads(params, images, captions_in, y_onehot, masks) -> (loss,
    {"accuracy"}, grads)`` of the sharded train step: the batch ``Sharded``
    over the slots, ``masks`` the global batch's dropout masks (or None),
    the gradient summed over the slots and the processes."""
    loss_fn = captioner.loss_fn()

    def grads(params, images, captions_in, y_onehot, masks):
        B = images.global_rows
        reps = replicas(mesh, params)

        def slot_loss(i, p):
            dev, y = mesh.slots[i], y_onehot.shards[i]
            m = None if masks is None else mask_rows(masks, images.rows[i], dev)
            if shard_vocab:
                logits = vocab_sharded_forward(captioner, p, images.shards[i],
                                               captions_in.shards[i], m, mesh.devices[i])
                loss, counts = vocab_sharded_loss(captioner, logits, y)
                return loss * (y.shape[0] / B), counts
            logits = captioner.forward_train(p, images.shards[i], captions_in.shards[i], None,
                                             masks=m)
            return (loss_fn(logits, y) * (y.shape[0] / B),
                    masked_accuracy_counts(logits.detach(), y))

        loss, accuracy, g = sharded_value_and_grad(mesh, reps, slot_loss)
        return loss, {"accuracy": accuracy}, g

    return grads


def make_sharded_train_step(captioner, optimizer, mesh, shard_vocab: bool = False,
                            params_template=None, donate: bool = True, opt_state_template=None):
    """Mesh-parallel train step: the batch split over the data slots, the
    params replicated. Returns ``(step, place_state)``: ``step(params,
    opt_state, images, captions_in, y_onehot, generator, masks=None)`` as
    ``make_train_step``'s, the batch arrays global (host arrays or tensors)
    or ``Sharded`` (``parallel.shard_batch``, ``global_batch_from_local``);
    ``masks`` (the global batch's dropout masks) replace the generator's
    draw. ``place_state(params, opt_state)`` moves the state where the step
    keeps it. ``shard_vocab`` splits the embedding and the output projection
    over the mesh's model axis (the module's docstring; ``place_state``
    slices them, ``parallel.gather_params`` joins them again). ``donate``
    and the templates: ``undonated`` and ``place_on_mesh``."""
    step = sharded_step(captioner, optimizer, mesh, sharded_train_grads(captioner, mesh,
                                                                        shard_vocab))
    return undonated(step, donate), place_on_mesh(mesh, shard_vocab, params_template,
                                                  opt_state_template)


def sharded_step(captioner, optimizer, mesh, grads_of):
    """The sharded step over ``grads_of`` (``sharded_train_grads`` or the
    fine-tune's): the batch placed, the global batch's dropout drawn, the
    summed gradient's clipped Adam update."""
    def step(params, opt_state, images, captions_in, y_onehot, generator, masks=None):
        images, captions_in, y_onehot = sharded_batch(mesh, images, captions_in, y_onehot)
        masks = global_masks(captioner, params, images.global_rows, generator, masks)
        loss, metrics, grads = grads_of(params, images, captions_in, y_onehot, masks)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, dict(metrics, loss=loss)

    return step


def one_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is one slot in a group of one process (or none): its
    sharded step computes the one-device step (an all-reduce over one rank
    is the identity), so the trainers run its K steps a call as the
    one-device call, replayed from one captured step on a card. A graph
    belongs to one device and gloo cannot be captured; a NCCL group of
    several processes chains its sharded steps, its captured K-step call
    having not finished on four H100s (ROADMAP §C)."""
    return mesh.devices.size == 1 and mesh.process_count == 1


def sharded_multi(captioner, optimizer, mesh, grads_of):
    """K sharded steps a call over ``grads_of`` (``sharded_step``'s): ->
    ``multi(params, opt_state, images, captions_in, y_onehot, generator,
    masks=None)`` over (K, B, ...) stacks, global arrays or ``Sharded``
    split on axis 1 (``parallel.stacked_batch_sharding``,
    ``global_stacked_batch_from_local``); ``masks`` a list of K global
    batches' masks. The K sharded steps chained, the slots issued in
    turn."""
    step = sharded_step(captioner, optimizer, mesh, grads_of)

    def multi(params, opt_state, images, captions_in, y_onehot, generator, masks=None):
        stacks = [as_stacked(mesh, a) for a in (images, captions_in, y_onehot)]
        stacks[1] = stacks[1]._replace(shards=[c.long() for c in stacks[1].shards])
        K = stacks[0].shards[0].shape[0]
        return chain_steps(step, params, opt_state, [_steps_of(x, K) for x in stacks],
                           generator, masks)

    return multi


def _steps_of(stacked: Sharded, K: int) -> list:
    """A (K, B, ...) stack split on axis 1 as K batches ``Sharded`` on axis 0."""
    return [Sharded([s[k] for s in stacked.shards], stacked.global_rows, stacked.offset)
            for k in range(K)]


def make_sharded_multi_train_step(captioner, optimizer, mesh, shard_vocab: bool = False,
                                  params_template=None, donate: bool = True,
                                  opt_state_template=None):
    """K sharded train steps a call over (K, B, ...) stacks whose batch axis
    is split over the data slots, the JAX package's
    ``make_sharded_multi_train_step``: the same as K chained sharded steps
    (``make_sharded_train_step``). Returns ``(multi, place_state)``;
    ``multi`` as ``sharded_multi``'s."""
    multi = sharded_multi(captioner, optimizer, mesh, sharded_train_grads(captioner, mesh,
                                                                          shard_vocab))
    return undonated(multi, donate), place_on_mesh(mesh, shard_vocab, params_template,
                                                   opt_state_template)


def make_sharded_eval_step(captioner, mesh):
    """``make_eval_step`` over a mesh: each slot's loss times its rows and the
    accuracy's counts, summed over the slots and the processes, the loss
    then over the rows. A validation batch need not divide over the slots
    (the provider yields a ragged tail): it splits into near-equal parts."""
    loss_fn = captioner.loss_fn()

    @torch.no_grad()
    def eval_step(params, images, captions_in, y_onehot):
        if isinstance(images, Sharded):
            parts = [x.shards for x in (images, captions_in, y_onehot)]
        else:
            n = len(mesh.slots)
            parts = [torch.tensor_split(torch.as_tensor(x), n) for x in
                     (images, captions_in, y_onehot)]
        total = None
        for dev, p, x, c, y in zip(mesh.slots, replicas(mesh, params), *parts):
            if not len(x):
                continue
            with on_device(dev):
                x, c, y = x.to(dev), c.to(dev).long(), y.to(dev)
                logits = captioner.forward_train(p, x, c, None)
                part = torch.stack([loss_fn(logits, y) * y.shape[0],
                                    torch.tensor(float(y.shape[0]), device=dev),
                                    *masked_accuracy_counts(logits, y)]).to(mesh.primary)
            total = part if total is None else total + part
        loss_rows, rows, correct, valid = all_reduce_sum(total, mesh)
        return {"loss": loss_rows / rows, "accuracy": correct / valid.clamp(min=1)}

    return eval_step
