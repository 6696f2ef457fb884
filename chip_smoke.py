#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a card. It fails (exit 1,
no result line) when ``torch.cuda.is_available()`` is false, and when the
port's package is not beside it. Phases; any failure makes the exit code 1:

1. card:    the card's name and power limit, as nvidia-smi gives them, and
            what the host offers beyond the promised packages (PIL, yaml,
            nltk, psutil, h5py, matplotlib, java, the libjpeg/libpng headers);
2. kernels: builds the four CUDA kernels (one nvcc per source, in
            parallel), then holds each against its plain PyTorch version at
            the shapes of every main path it is on and times kernel, plain
            version and one library call (torch.matmul for lrp_linear,
            aten::_thnn_fused_lstm_cell for lstm_gates, F.conv2d for
            conv3x3_fused, F.conv_transpose2d in bf16 for lrp_a1b0_fused; the
            port never calls these). Bounds use the H100 SXM peaks: 3.35 TB/s,
            67 TFLOP/s f32 on the CUDA cores, 989 TFLOP/s bf16 on the tensor
            cores for the bf16 rule, 495 TFLOP/s TF32 for conv3x3_fused's
            three products per f32 product (3xTF32; its CUDA-core bound is
            logged beside). Each row and each kernel's per-batch
            sum gives the achieved TFLOP/s and the share of the bound
            (bound ms / ms). lstm_gates and its library call are timed as
            20 launches replayed from a CUDA graph, as the path runs them,
            and eagerly beside. Phase 2 takes the f32 path's shapes
            (batch 8), 2b the bf16 path's (batch 56: lrp_linear, lstm_gates,
            and lrp_a1b0_fused at the 12 post-ReLU conv shapes, 20 words),
            phase 2 also holds K3 on W- (the alpha2beta1 inhibitor, z
            negative and, over a zero quarter of x, exactly 0) to its plain
            version in f64; 2c the training paths' (batch 32, 21 steps): lstm_gates through
            its autograd Function, its gradient held to the plain version's
            and its backward timed (train), and lrp_linear, lstm_gates (two
            forwards under no_grad, one through the Function) and
            conv3x3_fused at the fine-tune step's shapes (finetune); 2d
            grid-TD's (the Explainer's gridtd_f32 at batch 8, gridtd_bf16 at
            56): lrp_linear with its two gate blocks a step (K = 1536 and
            2048), lstm_gates twice a step, the CNN kernel of each; 2e the
            entry points' (batch 32): lstm_gates over one epoch of
            Trainer.run (trainer), a grid-TD train step (gridtd_train) and
            the beam search of evaluate_test_set (evaluate);
3. main:    VGG16 / adaptive attention at full width (224x224 input, 14x14x512
            grid, E = H = 512, vocab 7003, beam 3, T = 20) on random weights
            from seed 0, f32, batch 8: one warm-up pass (it captures the
            caption and decoder-LRP graphs), one per-stage pass, the same
            two stages eagerly (held equal to the graphs), and one counted
            pass through ``caption_and_explain``; every kernel's launch
            count must match its calls on that path;
3b. main, bf16: the same at bench's batch 56 in bf16 storage
            (``build(storage_dtype=torch.bfloat16)``, bench.py's default mode);
4. card vs CPU: one image on the card and on the CPU (plain versions),
            tokens equal and maps within a stated tolerance, with the CNN LRP
            cut to the first 2 word seeds to keep the CPU time short;
4b. card vs CPU, bf16: one image in bf16 on the card and on the CPU, both
            held to a CPU-f32 run of the same image and words;
6. train:   three train steps at full width (FlickrConfig: batch 32, 21
            steps, dropout 0.5, lr 2e-4, Adam with clipvalue 0.1) on one
            random batch: every loss finite, the loss without dropout lower
            after them; ms a step, img/s, peak memory, launches a step;
6b. finetune: two LRP-inference fine-tune steps at the same size (mode
            'mean', lr 1e-6, every word explained), then one more step's
            three phases (predict, lrp_weights, update) timed apart;
6c. K steps a call (``--steps-per-call``): the train step at K = 4 and the
            fine-tune step at K = 2, batch 32, each step replayed from one
            captured CUDA graph (``graphs.StepGraph``), against K chained
            eager steps: with cuDNN's deterministic algorithms bit for bit
            (losses, params, Adam's moments), on a first call and on one
            after ``set_learning_rate``, the launches K x one step's; with
            its default ones (two eager chains already differ) the distance
            beside a second eager chain's, the losses within TOL_MULTI_LOSS,
            ms a step against the eager chain's, capture s, peak memory and
            the host's share of a call;
7. card vs CPU, fine-tune: one step at batch 1 without dropout on the card,
            on the CPU in f32 and in f64: gradients within FT_GRAD_RATIO of
            the CPU-f32 run's distance from f64, relevance weights within
            TOL_FT_WEIGHTS of their scale; the same gradients once more with
            dropout 0.5, one set of masks drawn on the CPU for all three;
8. Explainer: adaptive attention in bf16 storage at batch 56 over 224 images
            with natural caption lengths (bench_natural.py's draw): warmup,
            one timed analyze_many (img/s, the chunk-to-bucket plan, graph
            captures before and after, pool and output GiB, peak memory,
            launches held to the plan, one chunk's time by part), one
            analyze_many that decodes 56 images, warmup(sub_batches=True)
            and requests of 1-60 images after it (no capture, the pool's
            size unchanged), and analyze / analyze_batch / analyze_many held
            equal on three images;
8b. Explainer, f32, batch 8: analyze_batch with its decode, the entry
            points held equal, one image against CPU f32 and f64 (captions
            equal, maps within F64_RATIO of the CPU-f32 run's distance);
8c. grid-TD lrp: f32 at batch 8 and bf16 at batch 56, launches held to the
            derived counts, one image against the CPU;
8d. the gradient methods: each on one image with a 4-word caption (ms, K2's
            launches); the same Explainer's first word against CPU f32 and
            f64: the decoder gradient from each run's own encode, the CNN
            side on one shared seed (the f64 run's decoder gradient);
9. entry points: on a generated dataset whose training vocabulary is
            bench's 7003 words, its images seeded arrays handed to the
            provider (``seeded_images``), in ``build/phase9`` (removed after):
            9a Trainer.run at batch 32, two epochs of 8 steps, a new Trainer
            resuming the last checkpoint and one more epoch (its epoch split,
            the targets' copy to the card, peak memory, launches), then a
            Trainer at steps_per_call 4 on that checkpoint, one epoch that
            captures and one counted (launches, its step calls' ms); 9b the
            trainer at batch 2 on the card and on the CPU in f32 and f64;
            9c three grid-TD train steps in each loss mode, one step's
            gradients at batch 1 against the CPU; 9d BeamSearchInference's
            evaluate_test_set on 9a's checkpoint and LRPFinetuner.run
            through the provider;
10. explanation entry points: on 9d's checkpoint (its EOS logit pushed
            down: three epochs leave it decoding EOS first) and phase 9's
            dataset, its test images written as seeded JPEGs that the
            provider and the drivers decode, in ``build/phase10`` (removed
            after): 10a the f32
            Explainer's deep_taylor and deep_lift, analyze_batch of 8 images
            (img/s, launches held to the plan: deep_lift runs no K3), one
            image against CPU f32 and f64, each f32 walk held to the f64
            walk over its own forward; 10b evaluate_dataset and analyze_results over the 64 test
            images at batch 32, with an entities dict of two words of each
            image's own caption (img/s, analyze_many and the host's scoring
            apart, launches held to the plan), one image's scores against a
            CPU-f32 Explainer's; 10c frequent_object_map over beam
            evaluate_test_set's predictions, collect_word_stats on their 10
            commonest words and the three ROC-AUCs; 10d explain_image_file for lrp, deep_taylor
            and deep_lift and process_beam_search over 4 images (figures
            where the host has matplotlib); 10e ``cli.main`` explain,
            evaluate-bbox and analyze-words --roc-auc on the default device,
            on the mini-Flickr30k fixture at full width; 10f a Trainer with
            pretrained GloVe vectors over half the vocabulary;
11. other configurations: ResNet-101 (and ResNet-50) + adaptive attention,
            InceptionV3 + grid-TD at 299x299, AOA on VGG16, VGG19, at
            their published widths on seed-0 weights with BatchNorm
            statistics drawn: lrp at f32 batch 8 and bf16 56, the other
            methods on one image, one image against CPU f32 and f64, AOA's
            decode, train and fine-tune steps;
12. serving: VGG16 / adaptive attention at full width, seed-0 weights, in
            ``build/phase12`` (removed after): 12a CaptionService at batch
            8, warmup(explain=True), one caption and one counted explain
            request of 8 images (ms, img/s, graphs unchanged after warmup),
            the explanations bit for bit Explainer.analyze_batch's; one
            counted explain in bf16 storage; 12b the HTTP front-end with
            16 concurrent single-image clients, with the queue (linger 5
            ms: dispatches, p50/p99, requests/s, answers within
            TOL_SERVE_F16 of each image's direct explain) and without it
            (bit for bit), and what the npz and HTTP add to one request;
            12c the same over gRPC's raw and typed services where grpcio
            imports; 12d export_serving at batch 8 and ExportedService
            (export, load and warm-up seconds, program sizes, one counted
            explain: tokens equal 12a's, maps within 1e-6); 12f
            export_serving of guided_gradcam at batch 8 (one program at T,
            traced by make_fx, then torch.export) and ExportedService: one
            counted explain, tokens equal the live Explainer's, every array
            within 1e-6, K2's launches as derived; 12e the CLI's ``serve``
            live (mini fixture) and ``serve --exported`` in child
            processes, one /explain each. ``--only export_grad`` (12g, not
            in the whole run) holds all seven gradient methods so at word
            buckets EXPORT_BUCKETS and T;
13. analyzers: the analyzer catalogue on VGG16 up to block5_conv3 at
            224x224 (seeded weights, biases drawn; images over the
            preprocessed pixel range), batch 8, one seed an image: each of
            create_analyzer's 32 names timed (img/s, K3 launches held to 24
            an alpha1beta0 call and 48 an alpha2beta1 one), its image 0
            against CPU f32 and f64 runs (within ANALYZER_RATIO of the CPU
            run's distance, or the name's measured floor); the
            pattern names on patterns from two generated batches;
            gaussian_smoother and path_integrator over PresetA at n = 4;
            imgword_batched at 8 images x 20 words in f32 (K3, the
            analyzers_f32 path), bf16 storage (K4, analyzers_bf16) and bf16
            compute (neither), image 0's first words against the CPU;
            PerturbationAnalysis (zeros, 16x16 regions, 3 steps) over PresetA
            maps, scored by the tapped features' sum against the seed;
14. scale-out: VGG16 / adaptive attention at full width on a mesh of two
            data slots, both on cuda:0 (the one card; the port's counterpart
            of XLA's virtual devices), in ``build/phase14`` (removed after):
            14a one sharded train step at 32 (16 a slot), one at 32 with the
            vocabulary split over two model slots (shard_vocab), and 14b one
            sharded LRP-inference fine-tune step at 32, each against the
            one-device step on the same batch and dropout masks (loss,
            accuracy, the summed gradient before the clip, the params one
            Adam step gives); the labels are the one-device argmax on part
            of the rows, the first slot's captions the shorter, so the
            accuracy is not 0 and differs from the mean of the slots';
            14c the word-sharded Explainer.analyze of one image at bucket 20
            in f32 (K3) and bf16 storage (K4) against the unsharded analyze;
            14d the mesh analyze_many in bf16 at 56 (28 a slot) over
            natural-length captions and CaptionService(mesh, batch_size=8)'s
            explain against their one-device runs; 14e
            ExportedCaptioner(devices=[cuda:0, cuda:0]) on phase 12's
            artifact, two chunks dealt to the two slots against each chunk on
            the first slot; 14f groups started by ``torchrun``
            (``tests/torch_parallel_worker.py``'s launcher and rank), each
            rank a multihost Trainer at full width on its rows, each step
            held to the one-device step on rank 0 (loss, gradient, Adam
            flips, the ranks' params bit for bit): a 1-rank NCCL group whose
            mesh comes from the default ``make_multihost_mesh()`` (it must
            be [[cuda:0]]), a Trainer step, a fine-tune step and the
            Trainer's K-step call (K = 4: on a group of one rank the
            one-device call, its step captured and replayed, held to 4
            chained one-device steps, both under cuDNN's deterministic
            algorithms); a 2-rank
            gloo group (both ranks on cuda:0), a Trainer step;
            ``--nproc-per-node 2`` under NCCL on the one card, whose ranks
            must both raise the split's ValueError before joining; where
            two or more cards are visible, NCCL groups of 2 and 4 ranks (as
            the cards allow), one a card, both steps, else a line says they
            did not run. Every path's launches are held to each slot's
            derived counts, the mesh's ms or img/s beside one device's;
5.    card tests: ``pytest --noconftest -m cuda`` over the kernel, graph,
            training, trainer, encoder, serving and analyzer card tests, in a
            child process (run last).

Every path (f32, bf16, train, finetune, multi_train and multi_finetune
(phase 6c), gridtd_f32, gridtd_bf16, trainer,
gridtd_train, evaluate, phase 10's deep_taylor and bbox, phase 11's,
phase 12's serve_f32, serve_bf16 and exported, phase 13's
analyzers_f32 and analyzers_bf16, and phase 14's mesh_train, vocab_train,
mesh_finetune, shard_words_f32, shard_words_bf16, mesh_bf16, mesh_serve,
mesh_exported, multihost_train summed over the gloo ranks, multihost_nccl,
multi_nccl (14f's K-step call), and on several cards nccl_2_ranks and nccl_4_ranks a rank) is driven
with the launch counts set to 0 just before it and read just after; each
kernel's count must equal its calls on that path as phase 2's shapes derive
them (for deep_taylor and bbox the shapes of the run's chunks, timed after
it), 0 where it is not on it. The Explainer's other runs (phases 8, 8b, 8d,
10a's deep_lift, 10c) are held to the counts their bucket plans derive.

Prints the ``{"kernels": [...]}`` line, then the card line, then as the last
line ``{"ok": true, "device": {...}}``. Per-shape detail goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12    # H100 SXM f32 outside the tensor cores
PEAK_BF16_FLOP_S = 989e12  # H100 SXM bf16 on the tensor cores, dense
PEAK_TF32_FLOP_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
GRAPH_REPS = 20            # K2 launches a graph replays per timing (one decoder loop)
B_MAIN, VOCAB, BEAM, T = 8, 7003, 3, 20
B_BF16 = 56                # bench.py's batch
B_TRAIN = 32               # FlickrConfig.batch_size: the training paths' batch
T_TRAIN = 21               # FlickrConfig.sentence_length + 1: a training caption's steps
# phase 9's dataset and trainer run: train steps an epoch, validation and test images
TRAINER_STEPS, N_VAL, N_TEST = 8, 64, 64
SOS, EOS = 1, 2            # 1-based token ids
E = H = D = 512
L = 196
IMAGE = 224
CPU_WORDS = 2
# tolerances, relative to the scale (max |plain|) of each output: the divides
# by stab(z) at eps = 1e-7 amplify last-ulp differences of the sums, which the
# kernels take in another order than cuBLAS/cuDNN
TOL_KERNEL = 1e-4
TOL_CPU_MAPS = 1e-3
TOL_LSTM_ABS = 1e-5
# the bf16 rule and its plain version round at the same points: they differ by
# summation order and at most one bf16 rounding of the output (2^-8 of a value)
TOL_BF16_KERNEL = 1e-2
# phase 4: the card's distance from a CPU-f64 run, as a multiple of the CPU-f32
# run's own distance. An H100 80GB HBM3 at 700 W read 0.47x for the decoder-LRP
# maps (1.6e-3 against 3.5e-3 of scale) and 2.0x for the heatmaps (5.6e-4
# against 2.8e-4); the heatmaps also pass TOL_CPU_MAPS against CPU-f32.
F64_RATIO = {"r_feat": 2.0, "maps": 4.0}
# the floor under each ratio. Either run can flip a near-tie of its f32
# forward that moves a heatmap value by up to a few 1e-3 of the scale: over
# the first five images of phase 8's workload (scripts/explainer_consistency.py,
# H100 80GB HBM3 at 700 W) the card's f32 heatmaps read 4.6e-7 to 5.3e-4 from
# f64 and the CPU-f32 run's 5.9e-7 to 2.6e-3, the largest on different
# images; on phase 11's VGG encoders (scripts/config_f64_spread.py) and on
# phase 10a's checkpoint the card read up to 1.97e-3 where the CPU read
# 7e-7 to 7e-5. On an f64 forward rounded to f32 the card's walk reads 2e-7
# on those images, with K3 or its plain version alike (the script's
# --split): the forward's near-ties, not the walk. The heatmaps' floor is 2x
# the largest reading. The decoder maps' floor is 2x the largest reading on
# phase 9's trained checkpoint, as phase 10 takes it, over three phase-9 runs
# x three test images x deep_taylor and lrp (scripts/config_f64_spread.py
# --phase9 3): the card read 9.1e-7 to 3.11e-5 of scale, the CPU 1.02e-6 to
# 2.56e-4 (H100 80GB HBM3 at 700 W); 10a's one failure read 2.89e-5
F64_FLOOR = {"r_feat": 5.2e-4, "maps": 5.2e-3}
# phase 10a, on phase 9's trained checkpoint: the decoder LRP divides by
# z +- 1e-7 and DeepLIFT's CNN walk by the output difference y - y_ref, which
# cancels, so either carries the ~1e-7 rounding of one f32 forward into its
# result without bound, a new draw in each run: an H100 read DeepLIFT's maps
# 1.255e3 of their 2-norm from f64 where the CPU-f32 run read 8.6e-6, and on
# the CPU alone an f32 DeepLIFT walk lies 5e-3 to 1.9 from f64 while the same
# walk over its own forward, promoted to f64, lies 2e-6 from it
# (scripts/deeplift_conditioning.py). So each f32 run's walk is held to the
# f64 walk over that run's own forward (its features, caches and activations
# promoted exactly): the decoder LRP and DeepTaylor's maps (whose max pools a
# near-tie of the forward flips: 2.1e-3 of scale from f64 where the CPU read
# 5.5e-7) by the largest distance, DeepLIFT's maps by the 2-norm, within
# F64_RATIO or GRAD_MAPS_RATIO times the CPU-f32 run's distance, or TOL_WALK
# of the scale; the card's features within F64_RATIO["r_feat"] times the
# CPU's distance from the f64 features, or TOL_WALK. The distances between
# whole runs are logged beside.
TOL_WALK = 1e-4
# phase 4b: the card-bf16 heatmaps' distance from a CPU-f32 run, as a multiple
# of the CPU-bf16 run's own distance from it. An H100 80GB HBM3 at 700 W read
# 0.84x (7.6e-3 against 9.1e-3 of scale); 2x is also the CPU tests' bound for
# the port against JAX in bf16 (tests/test_torch_bf16.py).
BF16_CPU_RATIO = 2.0
# phase 2c: K2's gradient through its Function against autograd through the
# plain version, relative to each gradient's scale
TOL_LSTM_GRAD = 1e-6
# phase 7: the card's fine-tune gradients may lie at most this multiple of the
# CPU-f32 run's distance from a CPU-f64 run (floor 1e-6 of the scale), and its
# relevance weights within TOL_FT_WEIGHTS of their scale from the f64 ones
FT_GRAD_RATIO = 2.0
TOL_FT_WEIGHTS = 1e-3
# phase 7 with dropout: each leaf's gradient, by the 2-norm of its distance
# from f64 over its own 2-norm, within FT_GRAD_RATIO times the CPU-f32 run's on
# that leaf or within this floor. The worst leaf is decoder/attn/Wg (a softmax
# gradient that cancels), where f32 rounding alone lies ~1e-2 from f64 on the
# CPU as on the card and their ratio moves with the seeds past 2x
# (scripts/phase7_seeds.py); a dropped or misplaced gradient lies ~1 from f64
TOL_FT_GRAD_L2_FLOOR = 5e-2


def log(*a):
    print(*a, flush=True)


def probe_host() -> dict:
    """What the card's host offers beyond the promised packages: the Python
    modules the port imports only where a path needs them (grpcio and
    protobuf for the gRPC front-end), the java the
    metrics' jars need, and the libjpeg/libpng headers ``make -C native``
    compiles against (a syntax check in a temporary directory; nothing is
    built in the repository)."""
    import importlib.util
    import shutil
    import tempfile

    out = {m: importlib.util.find_spec(m) is not None
           for m in ("PIL", "yaml", "nltk", "psutil", "h5py", "matplotlib", "grpc",
                     "google.protobuf")}
    out["java"] = shutil.which("java") is not None
    cxx = shutil.which("g++") or shutil.which("c++")
    out["c++"] = cxx is not None
    for header in ("jpeglib.h", "png.h"):
        ok = False
        if cxx is not None:
            with tempfile.TemporaryDirectory() as d:
                src = os.path.join(d, "probe.cpp")
                with open(src, "w") as f:
                    f.write(f"#include <cstdio>\n#include <{header}>\nint main() {{ return 0; }}\n")
                ok = subprocess.run([cxx, "-fsyntax-only", src], capture_output=True,
                                    timeout=60).returncode == 0
        out[header] = ok
    return out


def time_ms(fn, min_total_ms: float = 30.0, max_reps: int = 50) -> float:
    """Mean device time of ``fn`` over enough launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    reps = max(1, min(max_reps, math.ceil(min_total_ms / once)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = GRAPH_REPS) -> float:
    """Mean device time of one ``fn`` call when ``reps`` of them replay from
    one CUDA graph (no host launch time between them), by CUDA events."""
    from lrp_imagecaptioning_torch.graphs import capture

    def calls():
        for _ in range(reps):
            fn()

    graph, _ = capture(calls)
    return time_ms(graph.replay) / reps


def bound_ms(nbytes: float, flops: float, peak_flop_s: float = PEAK_F32_FLOP_S,
             more_ops_ms: float = 0.0):
    """The larger of the bytes' and the operations' least time; ``more_ops_ms``
    adds operations at another peak (K3's f32 epilogue beside its TF32 MMAs)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flop_s * 1e3 + more_ops_ms
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    diff = (got - ref).abs().max().item()
    return diff, diff / max(ref.abs().max().item(), 1e-30)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


# phase 11's configurations: name -> (decoder, FlickrConfig fields over the
# defaults), and the paths each one's runs are counted on
CONFIGS = {
    "resnet101": ("adaptiveattention", dict(img_encoder="resnet101", layer_name="activation_49",
                                            img_feature_length=49, img_feature_dim=2048)),
    "resnet50": ("adaptiveattention", dict(img_encoder="resnet50", layer_name="activation_49",
                                           img_feature_length=49, img_feature_dim=2048)),
    "inception": ("gridTD", dict(img_encoder="inception_v3", layer_name="mixed10",
                                 img_feature_length=64, img_feature_dim=2048)),
    "aoa": ("aoa", {}),
    "vgg19": ("adaptiveattention", dict(img_encoder="vgg19", layer_name="block5_conv4")),
}
PATH_CONFIG = {"resnet101_f32": "resnet101", "inception_f32": "inception",
               "vgg19_f32": "vgg19", "vgg19_bf16": "vgg19", "aoa_f32": "aoa", "aoa_bf16": "aoa",
               "aoa_train": "aoa"}


def path_config(path):
    """(decoder, FlickrConfig) of a path: phase 11's, else VGG16's."""
    from lrp_imagecaptioning_torch.config import FlickrConfig

    model, over = CONFIGS[PATH_CONFIG[path]] if path in PATH_CONFIG else (
        "gridTD" if path.startswith("gridtd") else "adaptiveattention", {})
    return model, FlickrConfig(**over)


def _out_size(n, k, stride, padding):
    return -(-n // stride) if padding == "SAME" else (n - k) // stride + 1


def k3_layers(cfg):
    """(name, H = W, Cin, Cout) of each conv the f32 lrp walk hands K3 (a 3x3
    SAME stride-1 conv over a post-ReLU input), at the encoder's input size,
    derived from the models' layer lists."""
    from lrp_imagecaptioning_torch.data.images import encoder_image_size

    size, out = encoder_image_size(cfg.img_encoder)[0], []
    if cfg.img_encoder.startswith("vgg"):
        from lrp_imagecaptioning_torch.models.vgg import vgg_layers

        for op in vgg_layers(cfg.img_encoder, cfg.layer_name):
            if op[0] == "pool":
                size //= 2
            elif op[1] != "block1_conv1":   # the signed input layer takes the plain rule
                out.append((op[1], size, op[2], op[3]))
    elif cfg.img_encoder.startswith("resnet"):
        from lrp_imagecaptioning_torch.models.resnet import conv_names

        size = _out_size(_out_size(size + 6, 7, 2, "VALID"), 3, 2, "VALID")   # conv1, pool
        for name, _, (kh, _, cin, cout), stride in conv_names(cfg.img_encoder)[1:]:
            if name.endswith("2a"):
                size = _out_size(size, 1, stride, "VALID")
            elif name.endswith("2b"):
                out.append((name, size, cin, cout))
    else:
        from lrp_imagecaptioning_torch.models.inception import CONV_DIMS, SPEC

        sizes = {"input": size}
        for op in SPEC:
            if op[0] == "concat":
                sizes[op[1]] = sizes[op[2][0]]
                continue
            k, s, p = (op[4][0], op[5], op[6]) if op[0] == "conv" else (op[4], op[5], op[6])
            sizes[op[1]] = _out_size(sizes[op[2]], k, s, p)
            if op[0] == "conv" and op[4] == (3, 3) and s == 1 and p == "SAME" \
                    and op[2] != "input":
                out.append((op[1], sizes[op[2]], *CONV_DIMS[op[1]]))
    return out


def unique_layers(layers):
    """Layers of one shape taken once: [(names, H, Cin, Cout, count)]."""
    seen = {}
    for name, size, cin, cout in layers:
        seen.setdefault((size, cin, cout), []).append(name)
    return [(names[0] + (f"+{len(names) - 1}" if len(names) > 1 else ""), *shape, len(names))
            for shape, names in seen.items()]


def linear_shapes(path, batch, words):
    """The decoder LRP's products: one row per (image, explained word), as
    (name, M, Dout, Din, calls a pass). Adaptive: the gate-g block [x; h] a
    step; grid-TD: the language LSTM's [c_hat, h1; h2] (K = 2H + H) and the
    TD LSTM's [h2, g, e; h1] (K = H + 2E + H) a step; AOA: the gate-g block
    [x; h] (K = E + H + H) a step, the GLU over [q; hat], v_proj over L rows
    a word and q_proj, and image_features on the layer-normed grid. The
    Explainer's word buckets (PLAN_PATHS) explain ``words`` positions over
    all T steps."""
    model, cfg = path_config(path)
    R, L_, D_ = batch * words, cfg.img_feature_length, cfg.img_feature_dim
    steps = T if path in PLAN_PATHS else words
    if model == "gridTD":
        gates = [("lang_gate", R, H, 3 * H, T), ("td_gate", R, H, 2 * H + 2 * E, T)]
    elif model == "aoa":
        return [("output", R, VOCAB, H, 1), ("glu", R, H, 2 * H, 1), ("v_proj", R * L_, H, H, 1),
                ("q_proj", R, H, H, 1), ("gate_g", R, H, 2 * H + E, steps),
                ("w_img", R * L_, H, D_, 1)]
    else:
        gates = [("gate_g", R, H, 2 * E + H, steps)]
    return [("output", R, VOCAB, H, 1), *gates, ("w_glob", R, E, D_, 1), ("w_img", R * L_, H, D_, 1)]


def check_lrp_linear(gen, dev, path, dims=None):
    from lrp_imagecaptioning_torch.ops import kernels

    _, batch, words = dims or PATHS[path]
    rows = []
    for name, m, dout, din, calls in linear_shapes(path, batch, words):
        r = torch.randn(m, dout, generator=gen, device=dev)
        z = torch.randn(m, dout, generator=gen, device=dev)
        x = torch.randn(m, din, generator=gen, device=dev)
        w = torch.randn(din, dout, generator=gen, device=dev) / math.sqrt(dout)
        got = kernels.lrp_linear(r, x, z, w)
        ref = kernels.lrp_linear_plain(r, x, z, w)
        s = r / (z + torch.where(z >= 0, 1e-7, -1e-7))
        wt = w.T
        nbytes = 4 * (2 * m * dout + 2 * m * din + din * dout)
        flops = 2 * m * din * dout + 3 * m * dout + m * din
        rows.append(dict(shape=name, M=m, Dout=dout, Din=din, calls=calls,
                         err=rel_err(got, ref),
                         ms=time_ms(lambda: kernels.lrp_linear(r, x, z, w)),
                         plain_ms=time_ms(lambda: kernels.lrp_linear_plain(r, x, z, w)),
                         library_ms=time_ms(lambda: torch.matmul(s, wt)),
                         flops=flops, bound=bound_ms(nbytes, flops)))
    return rows


def check_lstm_gates(gen, dev, path, dims=None):
    """The serving paths replay K2 from CUDA graphs (beam search, cached
    forward); the training paths run it eagerly: the train step's teacher-
    forced forward with its gradient (``check_lstm_gates_grad``), the fine-
    tune step's three forwards (predict, the cached forward of lrp_weights,
    the dual loss's)."""
    from lrp_imagecaptioning_torch.ops import kernels

    _, batch, words = dims or PATHS[path]
    if path in ("train", "aoa_train"):
        return [check_lstm_gates_grad(gen, dev, batch, words)]
    if path == "gridtd_train":   # two LSTMs a step
        return [check_lstm_gates_grad(gen, dev, batch, 2 * words)]
    if path == "trainer":
        # an epoch: the train steps (through the Function), the validation
        # split's eval steps and the test split's greedy decode (no_grad)
        return [check_lstm_gates_grad(gen, dev, batch, TRAINER_STEPS * words),
                lstm_forward_row(gen, dev, batch, N_VAL // batch * words, "validation",
                                 grad=False)[0],
                lstm_forward_row(gen, dev, batch, N_TEST // batch * T, "greedy_decode",
                                 grad=False)[0]]
    if path == "evaluate":     # eager beam search, BEAM rows an image
        return [lstm_forward_row(gen, dev, batch * BEAM, N_TEST // batch * T, "beam",
                                 grad=False)[0]]
    if path == "finetune":
        # predict and lrp_weights' cached forward run K2 under no_grad, the
        # dual loss's forward through the Function
        return [lstm_forward_row(gen, dev, batch, 2 * words, "no_grad x2", grad=False)[0],
                lstm_forward_row(gen, dev, batch, words, "teacher_forced", grad=True)[0]]
    rows = []
    # grid-TD runs two LSTMs a step
    calls = 2 * T if path_config(path)[0] == "gridTD" else T
    for name, b in (("beam", batch * BEAM), ("cached_forward", batch)):
        zx = torch.randn(b, 4 * H, generator=gen, device=dev)
        zh = torch.randn(b, 4 * H, generator=gen, device=dev)
        bias = torch.randn(4 * H, generator=gen, device=dev)
        c = torch.randn(b, H, generator=gen, device=dev)
        z1, h1, c1 = kernels.lstm_gates(zx, zh, bias, c)
        z0, h0, c0 = kernels.lstm_gates_plain(zx, zh, bias, c)
        # z_pre must be bit for bit the plain sum: its error joins h's and c's
        err = max(rel_err(z1, z0), rel_err(h1, h0), rel_err(c1, c0))
        # ATen's fused LSTM cell (CUDA only): the same function, gates
        # [i, f, g, o] from input gates + hidden gates + input bias
        # (it takes both biases or neither: the hidden one is 0 here)
        fused_cell = torch.ops.aten._thnn_fused_lstm_cell
        zero_bias = torch.zeros_like(bias)
        hl, cl, _ = fused_cell(zx, zh, c, bias, zero_bias)
        kern = lambda: kernels.lstm_gates(zx, zh, bias, c)
        lib = lambda: fused_cell(zx, zh, c, bias, zero_bias)
        # the path replays K2 from CUDA graphs: its time is the in-graph
        # device time; the eager time (host launch cost included) stands beside it
        rows.append(dict(shape=name, B=b, H=H, calls=calls, err=err,
                         z_pre_exact=bool(torch.equal(z1, z0)),
                         library_err=max(rel_err(hl, h0), rel_err(cl, c0)),
                         ms=graph_ms(kern), eager_ms=time_ms(kern),
                         plain_ms=time_ms(lambda: kernels.lstm_gates_plain(zx, zh, bias, c)),
                         library_ms=graph_ms(lib), library_eager_ms=time_ms(lib),
                         # 8 adds for z_pre, then the tail's 5 transcendentals and 5 ops
                         flops=18 * b * H,
                         # zx, zh (4H), c_prev (H) read, z_pre (4H), h, c (H) written; b
                         bound=bound_ms(4 * (b * 15 * H + 4 * H), 18 * b * H)))
    return rows


def lstm_forward_row(gen, dev, batch, calls, shape, grad):
    """K2 at (batch, H), eagerly: through its autograd Function on inputs
    that require grad (``grad``), as the forward a loss is taken of runs it,
    else under no_grad. Returns (row, inputs, outputs, plain outputs)."""
    from lrp_imagecaptioning_torch.ops import kernels

    ins = [torch.randn(batch, 4 * H, generator=gen, device=dev) * 2 for _ in range(2)]
    ins += [torch.randn(4 * H, generator=gen, device=dev),
            torch.randn(batch, H, generator=gen, device=dev)]
    if grad:
        ins = [t.requires_grad_() for t in ins]
    zx, zh, bias, c_prev = (t.detach() for t in ins)
    fused_cell = torch.ops.aten._thnn_fused_lstm_cell
    zero_bias = torch.zeros_like(bias)
    with torch.set_grad_enabled(grad):
        outs = kernels.lstm_gates(*ins)
        ref_outs = kernels.lstm_gates_plain(*ins)
        row = dict(shape=shape, B=batch, H=H, calls=calls,
                   err=max(rel_err(o.detach(), r.detach()) for o, r in zip(outs, ref_outs)),
                   z_pre_exact=bool(torch.equal(outs[0], ref_outs[0])),
                   ms=time_ms(lambda: kernels.lstm_gates(*ins)),
                   plain_ms=time_ms(lambda: kernels.lstm_gates_plain(*ins)),
                   library_ms=time_ms(lambda: fused_cell(zx, zh, c_prev, bias, zero_bias)),
                   flops=18 * batch * H,
                   bound=bound_ms(4 * (batch * 15 * H + 4 * H), 18 * batch * H))
    return row, ins, outs, ref_outs


def check_lstm_gates_grad(gen, dev, batch, words):
    """Phase 2c: K2 at the training shapes through its autograd Function, run
    eagerly as a train step runs it. Its outputs against the plain version,
    its gradient against autograd through the plain version (TOL_LSTM_GRAD of
    each gradient's scale), and the backward's time (``lstm_gates_vjp``, torch
    ops) beside autograd's through the plain version."""
    from lrp_imagecaptioning_torch.ops import kernels

    row, ins, outs, ref_outs = lstm_forward_row(gen, dev, batch, words, "teacher_forced", True)
    cot = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    got = torch.autograd.grad(outs, ins, cot, retain_graph=True)
    ref = torch.autograd.grad(ref_outs, ins, cot, retain_graph=True)
    c_prev = ins[3].detach()
    z_pre, c = outs[0].detach(), outs[2].detach()
    return dict(row, grad_err=max(rel_err(g, r)[1] for g, r in zip(got, ref)),
                backward_ms=time_ms(lambda: kernels.lstm_gates_vjp(z_pre, c_prev, c, *cot)),
                plain_backward_ms=time_ms(
                    lambda: torch.autograd.grad(ref_outs, ins, cot, retain_graph=True)))


def check_conv3x3_fused(gen, dev, path, dims=None, w_minus=False):
    """K3's two passes at each shape of the path's walk (layers of one shape
    timed once, their calls counted); ResNet's and Inception's convs have no
    bias. ``w_minus``: the alpha2beta1 inhibitor's pair, on W- with no bias
    and x zero over a quarter of the image, so z = conv(x, W-) is negative
    and, inside that quarter, exactly 0 (SafeDivide's eps); held to the
    plain version in f64."""
    from lrp_imagecaptioning_torch.ops import kernels

    _, batch, n = dims or PATHS[path]   # per image: its n explained words as the batch
    cfg = path_config(path)[1]
    with_bias = cfg.img_encoder.startswith("vgg") and not w_minus
    rows = []
    for name, size, cin, cout, count in unique_layers(k3_layers(cfg)):
        hw = size * size
        x = torch.relu(torch.randn(1, size, size, cin, generator=gen, device=dev))
        r = torch.randn(n, size, size, cout, generator=gen, device=dev)
        kp = torch.rand(3, 3, cin, cout, generator=gen, device=dev) * math.sqrt(6.0 / (9 * (cin + cout)))
        if w_minus:
            x[:, :size // 2, :size // 2] = 0.0
            kp, name = -kp, f"{name}/W-"
        b = torch.rand(cout, generator=gen, device=dev) * 0.01 if with_bias else None
        kt = kernels.flip_transpose_kernel(kp)
        s = kernels.conv3x3_fused(x, r, kp, b, "divide")
        passes = {
            # divide: z = conv(x, W+) + b once for the shared x, then N quotients
            "divide": (lambda: kernels.conv3x3_fused(x, r, kp, b, "divide"),
                       lambda: kernels.conv3x3_fused_plain(x, r, kp, b, "divide"),
                       x, kp,
                       4 * (hw * cin + 2 * n * hw * cout + 9 * cin * cout + cout * with_bias),
                       2 * hw * 9 * cin * cout, 3 * n * hw * cout),
            # multiply: out = x * conv(s, flipT(W+)) for N seeds
            "multiply": (lambda: kernels.conv3x3_fused(s, x, kt, None, "multiply"),
                         lambda: kernels.conv3x3_fused_plain(s, x, kt, None, "multiply"),
                         s, kt,
                         4 * (n * hw * cout + hw * cin + 9 * cin * cout + n * hw * cin),
                         2 * n * hw * 9 * cin * cout, n * hw * cin),
        }
        # on W-, the quotients where z is 0 are ~1e7 times the others: cuDNN's
        # f32 algorithms (Winograd, FFT) spread that range's rounding onto the
        # neighbours, so the plain version is held in f64 there
        ref64 = {"divide": lambda: kernels.conv3x3_fused_plain(x.double(), r.double(),
                                                               kp.double(), None, "divide"),
                 "multiply": lambda: kernels.conv3x3_fused_plain(s.double(), x.double(),
                                                                 kt.double(), None, "multiply")}
        for mode, (kern, plain, conv_in, taps, nbytes, conv_flops, epi_flops) in passes.items():
            conv_nchw, taps_oihw = conv_in.permute(0, 3, 1, 2), taps.permute(3, 2, 0, 1)
            ms = time_ms(kern)
            flops = conv_flops + epi_flops
            err = rel_err(kern().double(), ref64[mode]()) if w_minus else rel_err(kern(), plain())
            rows.append(dict(shape=f"{name}/{mode}", N=n, H=size, W=size, Cin=cin, Cout=cout,
                             calls=batch * count, err=err,
                             ms=ms, plain_ms=time_ms(plain),
                             library_ms=time_ms(lambda: F.conv2d(conv_nchw, taps_oihw, padding=1)),
                             flops=flops,
                             # 3xTF32: three tensor-core products per f32 product,
                             # the f32 epilogue on the CUDA cores
                             tc_flops=3 * conv_flops, tc_tflops=3 * conv_flops / ms / 1e9,
                             bound=bound_ms(nbytes, 3 * conv_flops, PEAK_TF32_FLOP_S,
                                            epi_flops / PEAK_F32_FLOP_S * 1e3),
                             bound_cuda_core=bound_ms(nbytes, flops)))
        del x, r, s
    return rows


def check_lrp_a1b0_fused(gen, dev, path, dims=None):
    """The bf16 rule at the post-ReLU conv shapes of the path's VGG (layers
    of one shape timed once, their calls counted), 20 words."""
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.ops.lrp_conv import conv2d

    _, batch, n = dims or PATHS[path]
    rows = []
    bf = torch.bfloat16
    for name, size, cin, cout, count in unique_layers(k3_layers(path_config(path)[1])):
        hw = size * size
        x = torch.relu(torch.randn(1, size, size, cin, generator=gen, device=dev)).to(bf)
        r = torch.randn(n, size, size, cout, generator=gen, device=dev).to(bf)
        k = (torch.randn(3, 3, cin, cout, generator=gen, device=dev)
             * math.sqrt(2.0 / (9 * cin))).to(bf)          # signed: the rule takes W+
        b = (torch.rand(cout, generator=gen, device=dev) * 0.01).to(bf)
        # the library call: cuDNN's bf16 transposed conv of the same s, alone
        kp = k * (k >= 0)
        zf = (conv2d(x, kp) + b).float()
        s_nchw = (r.float() / (zf + (zf == 0).float() * 1e-7)).to(bf).permute(0, 3, 1, 2)
        kp_t = kp.permute(3, 2, 0, 1).contiguous()
        kern = lambda: kernels.lrp_a1b0_fused(r, x, k, b)
        plain = lambda: kernels.lrp_a1b0_fused_plain(r, x, k, b)
        # r, x, kernel, bias read once, out written once; z conv + transposed conv
        nbytes = 2 * (n * hw * cout + hw * cin + 9 * cin * cout + cout + n * hw * cin)
        flops = 2 * hw * 9 * cin * cout + 2 * n * hw * 9 * cin * cout + 3 * n * hw * cout \
            + n * hw * cin
        rows.append(dict(shape=name, N=n, H=size, W=size, Cin=cin, Cout=cout, calls=batch * count,
                         err=rel_err(kern().float(), plain().float()),
                         ms=time_ms(kern), plain_ms=time_ms(plain),
                         library_ms=time_ms(lambda: F.conv_transpose2d(s_nchw, kp_t, padding=1)),
                         flops=flops, bound=bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)))
        del x, r, s_nchw
    return rows


KERNEL_META = {
    "lrp_linear": ("lrp_imagecaptioning_torch/csrc/lrp_linear.cu",
                   "lrp_imagecaptioning_tpu/ops/pallas_kernels.py:48", check_lrp_linear),
    "lstm_gates": ("lrp_imagecaptioning_torch/csrc/lstm_gates.cu",
                   "lrp_imagecaptioning_tpu/ops/pallas_kernels.py:107", check_lstm_gates),
    "conv3x3_fused": ("lrp_imagecaptioning_torch/csrc/conv3x3_fused.cu",
                      "lrp_imagecaptioning_tpu/ops/pallas_conv_lrp.py:77", check_conv3x3_fused),
    # K4 (:64); the same kernel replaces K5 (:142)
    "lrp_a1b0_fused": ("lrp_imagecaptioning_torch/csrc/lrp_a1b0_fused.cu",
                       "experiments/pallas_block1_v2.py:64", check_lrp_a1b0_fused),
}
ALSO_REPLACES = {"lrp_a1b0_fused": "experiments/pallas_block1_v2.py:142"}
# max |kernel - plain|: over the plain version's scale, or absolute for lstm_gates
TOLERANCE = {"lrp_linear": ("rel", TOL_KERNEL), "lstm_gates": ("abs", TOL_LSTM_ABS),
             "conv3x3_fused": ("rel", TOL_KERNEL), "lrp_a1b0_fused": ("rel", TOL_BF16_KERNEL)}


# the main paths: name -> (storage_dtype, batch, words a caption), and the
# kernels each launches. "f32" and "bf16" caption and explain a batch
# (phases 3, 3b); "train" is one train step (phase 6), "finetune" one
# LRP-inference fine-tune step (phase 6b), both f32 at the config's batch;
# "trainer" is one epoch of Trainer.run (phase 9a: TRAINER_STEPS train steps,
# the validation split's eval steps, the greedy decode of the test split),
# "gridtd_train" one grid-TD train step (9c), "evaluate" one
# BeamSearchInference.evaluate_test_set over the test split (9d)
PATHS = {"f32": (None, B_MAIN, T), "bf16": (torch.bfloat16, B_BF16, T),
         "train": (None, B_TRAIN, T_TRAIN), "finetune": (None, B_TRAIN, T_TRAIN),
         "gridtd_f32": (None, B_MAIN, T), "gridtd_bf16": (torch.bfloat16, B_BF16, T),
         "trainer": (None, B_TRAIN, T_TRAIN), "gridtd_train": (None, B_TRAIN, T_TRAIN),
         "evaluate": (None, B_TRAIN, T), "aoa_train": (None, B_TRAIN, T_TRAIN)}
PATH_KERNELS = {"f32": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
                "bf16": ("lrp_linear", "lstm_gates", "lrp_a1b0_fused"),
                "train": ("lstm_gates",),
                "finetune": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
                "gridtd_f32": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
                "gridtd_bf16": ("lrp_linear", "lstm_gates", "lrp_a1b0_fused"),
                "trainer": ("lstm_gates",), "gridtd_train": ("lstm_gates",),
                "evaluate": ("lstm_gates",),
                "deep_taylor": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
                "bbox": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
                "aoa_train": ("lstm_gates",),
                **{p: ("lrp_linear", "lstm_gates", "conv3x3_fused")
                   for p in ("resnet101_f32", "inception_f32", "vgg19_f32", "aoa_f32")},
                **{p: ("lrp_linear", "lstm_gates", "lrp_a1b0_fused")
                   for p in ("vgg19_bf16", "aoa_bf16", "serve_bf16")},
                "serve_f32": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
                "exported": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
                "exported_grad": ("lstm_gates",)}
# the paths whose dispatches the Explainer plans from its captions' lengths
# (phases 10 and 11): "deep_taylor" one analyze_batch of B_MAIN images, "bbox"
# the analyze_many calls of evaluate_dataset over the test split at B_TRAIN,
# phase 11's one analyze_batch each (f32 at B_MAIN, bf16 at B_BF16) on its
# configuration (PATH_CONFIG), phase 12's one explain request of B_MAIN
# images through CaptionService (serve_f32; serve_bf16 in bf16 storage) and
# through the exported programs (exported; exported_grad guided_gradcam's);
# their kernels are timed at the shapes of that run's chunks, (images, word
# bucket)
PLAN_PATHS = ("deep_taylor", "bbox", "resnet101_f32", "inception_f32", "vgg19_f32", "vgg19_bf16",
              "aoa_f32", "aoa_bf16", "serve_f32", "serve_bf16", "exported", "exported_grad")
PATH_TITLES = {"bf16": "phase 2b: the bf16 path's kernels vs their plain versions, batch {b}",
               "train": "phase 2c: the train path's kernel, K2 with its gradient, batch {b}",
               "finetune": "phase 2c: the fine-tune path's kernels, batch {b} x {w} words",
               "gridtd_f32": "phase 2d: grid-TD's kernels (Explainer, f32), batch {b} x {w} words",
               "gridtd_bf16": "phase 2d: grid-TD's kernels (Explainer, bf16), batch {b} x {w} words",
               "trainer": "phase 2e: one epoch of Trainer.run's kernel, batch {b}",
               "gridtd_train": "phase 2e: a grid-TD train step's kernel, batch {b}",
               "evaluate": "phase 2e: beam search over the test split, batch {b}",
               "aoa_train": "phase 2f: an AOA train step's kernel, batch {b}"}


def phase_kernels(dev, failures):
    """Each kernel at the shapes of every path it is on; rows carry their
    path, and the summary is per kernel and path."""
    gen = torch.Generator(device=dev).manual_seed(1)
    detail, summary = {name: [] for name in KERNEL_META}, {name: {} for name in KERNEL_META}
    for path, (_, batch, words) in PATHS.items():
        if path in PATH_TITLES:
            log(PATH_TITLES[path].format(b=batch, w=words))
        for name, (_, _, check) in KERNEL_META.items():
            if name not in PATH_KERNELS[path]:
                continue
            rows = check(gen, dev, path)
            summary[name][path] = summarize_rows(name, path, batch, rows, failures)
            detail[name] += rows
    log(f"phase 2: K3 on W- (the alpha2beta1 inhibitor: negative and zero z), the f32 path's "
        f"shapes, batch {B_MAIN}")
    rows = check_conv3x3_fused(gen, dev, "f32", w_minus=True)
    w_minus = summarize_rows("conv3x3_fused", "w_minus", B_MAIN, rows, failures)
    return summary, dict(detail, conv3x3_fused_w_minus=dict(rows=rows, summary=w_minus))


def summarize_rows(name, path, batch, rows, failures):
    """Log ``name``'s rows on ``path`` (each against its plain version and
    tolerance) and their per-batch sums: ms, plain and library ms, bound, calls."""
    kind, tol = TOLERANCE[name]
    for row in rows:
        row["path"] = path
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["share_of_bound"] = row["bound"][0] / row["ms"]
        extra = f"  library rel {row['library_err'][1]:.3e}" if "library_err" in row else ""
        if "eager_ms" in row:
            extra += (f"  (in a graph; eager {row['eager_ms']:.4f}, library eager "
                      f"{row['library_eager_ms']:.4f}; z_pre exact {row['z_pre_exact']})")
        if "bound_cuda_core" in row:
            extra += (f"  tensor cores {row['tc_tflops']:.2f} TFLOP/s; CUDA-core bound "
                      f"{row['bound_cuda_core'][0]:.4f}")
        if "grad_err" in row:
            extra += (f"  (eager; gradient rel {row['grad_err']:.3e}; backward "
                      f"{row['backward_ms']:.4f}, plain backward "
                      f"{row['plain_backward_ms']:.4f})")
            if row["grad_err"] > TOL_LSTM_GRAD:
                failures.append(f"{name} {row['shape']} ({path}): gradient differs from "
                                f"the plain version's by {row['grad_err']:.3e} of scale")
        log(f"  {path:4s} {name:14s} {row['shape']:22s} calls/batch {row['calls']:3d}  "
            f"max_abs {row['err'][0]:.3e} rel {row['err'][1]:.3e}  ms {row['ms']:.4f}  "
            f"plain {row['plain_ms']:.4f}  library {row['library_ms']:.4f}  "
            f"bound {row['bound'][0]:.4f} ({row['bound'][1]})  "
            f"{row['tflops']:.2f} TFLOP/s  {100 * row['share_of_bound']:.1f} % of bound"
            f"{extra}")
        if row.get("z_pre_exact") is False:
            failures.append(f"{name} {row['shape']} ({path}): z_pre differs from the plain sum")
        if (row["err"][0] if kind == "abs" else row["err"][1]) > tol:
            failures.append(f"{name} {row['shape']} ({path}) disagrees with its plain "
                            f"version: {row['err']}")
    per_batch = lambda key: sum(r.get(key, 0.0) * r["calls"] for r in rows)
    by_ops = sum(r["bound"][0] * r["calls"] for r in rows if r["bound"][1] == "operations")
    total_bound = sum(r["bound"][0] * r["calls"] for r in rows)
    ms = per_batch("ms")
    s = dict(
        batch=batch,
        calls_per_batch=sum(r["calls"] for r in rows),
        max_abs_err=max(r["err"][0] for r in rows),
        max_rel_err=max(r["err"][1] for r in rows),
        ms=ms, plain_ms=per_batch("plain_ms"),
        bound_ms=total_bound,
        bound_by="operations" if by_ops >= total_bound / 2 else "bytes",
        library_ms=per_batch("library_ms"),
        tflops=per_batch("flops") / ms / 1e9,
        share_of_bound=total_bound / ms,
    )
    extra = ""
    if "eager_ms" in rows[0]:
        s.update(eager_ms=per_batch("eager_ms"), library_eager_ms=per_batch("library_eager_ms"))
        extra = (f"  (in graphs; eager {s['eager_ms']:.3f}, library eager "
                 f"{s['library_eager_ms']:.3f})")
    if "bound_cuda_core" in rows[0]:
        s.update(tc_tflops=per_batch("tc_flops") / ms / 1e9,
                 bound_cuda_core_ms=sum(r["bound_cuda_core"][0] * r["calls"] for r in rows))
        s["share_of_cuda_core_bound"] = s["bound_cuda_core_ms"] / ms
        extra = (f"  tensor cores {s['tc_tflops']:.2f} TFLOP/s; CUDA-core bound "
                 f"{s['bound_cuda_core_ms']:.3f} ({100 * s['share_of_cuda_core_bound']:.1f} %)")
    if "grad_err" in rows[0]:
        s.update(grad_err=max(r["grad_err"] for r in rows if "grad_err" in r),
                 backward_ms=per_batch("backward_ms"),
                 plain_backward_ms=per_batch("plain_backward_ms"))
        extra = (f"  (eager; backward {s['backward_ms']:.3f}, plain backward "
                 f"{s['plain_backward_ms']:.3f})")
    log(f"  {path:4s} {name:14s} per batch: ms {ms:.3f}  plain {s['plain_ms']:.3f}  "
        f"library {s['library_ms']:.3f}  bound {total_bound:.3f}  "
        f"{s['tflops']:.2f} TFLOP/s  {100 * s['share_of_bound']:.1f} % of bound{extra}")
    return s


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def phase_main(dev, failures, batch=B_MAIN, storage_dtype=None):
    """Warm-up, per-stage and counted passes of ``caption_and_explain``; the
    launch counts are read from the counted pass alone."""
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.pipeline import build

    cfg = FlickrConfig()
    fn, cap = build(cfg, VOCAB, device=dev, beam=BEAM, T=T, storage_dtype=storage_dtype)
    params = cap.init_params(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(batch, IMAGE, IMAGE, 3, generator=gen, device=dev)

    t0 = time.perf_counter()
    fn(params, images)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    st = fn.stages
    t0 = time.perf_counter()
    feat, tokens = st["caption"](params, images)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r_feat = st["decoder_lrp"](params, feat, tokens)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st["cnn_lrp"](params, images, r_feat)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stage_ms = {"caption": (t1 - t0) * 1e3, "decoder_lrp": (t2 - t1) * 1e3,
                "cnn_lrp": (t3 - t2) * 1e3}
    del r_feat
    # the same two stage functions the graphs captured, called eagerly
    eager = fn.eager_stages
    t0 = time.perf_counter()
    feat_e, tokens_e = eager["caption"](params, images)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r_feat_e = eager["decoder_lrp"](params, feat_e, tokens_e)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stage_ms.update(caption_eager=(t1 - t0) * 1e3, decoder_lrp_eager=(t2 - t1) * 1e3)
    r_feat = st["decoder_lrp"](params, feat_e, tokens_e)
    graph_vs_eager = dict(tokens_equal=bool(torch.equal(tokens, tokens_e)),
                          r_feat_rel=rel_err(r_feat, r_feat_e)[1])
    if not graph_vs_eager["tokens_equal"] or graph_vs_eager["r_feat_rel"] > 1e-6:
        failures.append(f"graphed stages differ from the eager ones: {graph_vs_eager}")
    del r_feat, r_feat_e, feat_e

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, heatmaps = fn(params, images)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    reserved_gib = torch.cuda.max_memory_reserved() / 2**30
    # the CUDA graphs' private memory pools: segments outside the default
    # pool, in all and for the one graph each stage keeps
    segments = [(tuple(seg.get("segment_pool_id", (0, 0))), seg["total_size"])
                for seg in torch.cuda.memory_snapshot()]
    pools_gib = sum(size for pool, size in segments if pool != (0, 0)) / 2**30
    stage_pools_gib = {name: sum(size for pool, size in segments
                                 if pool == tuple(run.entry.graph.pool())) / 2**30
                       for name, run in fn.graphed.items()}
    captures = {k: g.captures for k, g in fn.graphed.items()}

    log(f"  warm-up pass {warm_s * 1e3:.1f} ms (first calls and graph captures included)")
    log(f"  stages ms: " + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items()))
    log(f"  graphs vs eager: {graph_vs_eager}; captures {captures}")
    log(f"  counted pass {total_s * 1e3:.1f} ms = {batch / total_s:.3f} img/s at batch {batch}; "
        f"peak memory {peak_gib:.2f} GiB allocated, {reserved_gib:.2f} GiB reserved; "
        f"the graphs' pools hold {pools_gib:.2f} GiB "
        f"({', '.join(f'{k} {v:.3f}' for k, v in stage_pools_gib.items())})")
    log(f"  launches {launches}")
    log(f"  tokens[0] {tokens[0].tolist()}")
    if tuple(tokens.shape) != (batch, T):
        failures.append(f"tokens shape {tuple(tokens.shape)}")
    if tuple(heatmaps.shape) != (batch, T, IMAGE, IMAGE, 3):
        failures.append(f"heatmaps shape {tuple(heatmaps.shape)}")
    if not bool(torch.isfinite(heatmaps).all()):
        failures.append("heatmaps hold non-finite values")
    if not bool(heatmaps.abs().amax(dim=(2, 3, 4)).gt(0).all()):
        failures.append("a heatmap is all zeros")
    main = dict(batch=batch, storage_dtype=str(storage_dtype), warm_ms=warm_s * 1e3,
                stage_ms=stage_ms, total_ms=total_s * 1e3, img_per_s=batch / total_s,
                peak_gib=peak_gib, reserved_gib=reserved_gib, graph_pools_gib=pools_gib,
                stage_pools_gib=stage_pools_gib, graph_vs_eager=graph_vs_eager,
                captures=captures, launches=launches, tokens0=tokens[0].tolist())
    del heatmaps
    return launches, main, (fn, cap, cfg, params, images)


def worst(a, b, n):
    """The largest distance, over the first ``n`` words of image 0, of a's
    map from b's, relative to b's scale."""
    return max(rel_err(a[0, t].double(), b[0, t].double())[1] for t in range(n))


def phase_cpu(built, failures):
    """One image on the card, on the CPU in f32 and on the CPU in f64.

    The decoder LRP divides by stab(z) = z +- 1e-7 over signed z, so f32
    differences of ~1e-6 in the features grow where |z| is small; the f64 run
    is the anchor: the card must stay within F64_RATIO times the CPU-f32
    run's own deviation from it (floor 1e-5 of the scale), and the card and
    CPU-f32 heatmaps within TOL_CPU_MAPS of their scale."""
    from lrp_imagecaptioning_torch.pipeline import build
    from lrp_imagecaptioning_torch.weights import tree_to

    fn, cap, cfg, params, images = built
    img = images[:1]
    st = fn.stages
    feat_g, tok_g = st["caption"](params, img)
    r_g = st["decoder_lrp"](params, feat_g, tok_g).cpu()
    maps_g = st["cnn_lrp"](params, img, r_g[:, :CPU_WORDS].to(img.device)).cpu()

    fn_c, _ = build(cfg, VOCAB, device="cpu", beam=BEAM, T=T)
    st_c = fn_c.stages
    params_c, img_c, tok = tree_to(params, "cpu"), img.cpu(), tok_g.cpu()
    t0 = time.perf_counter()
    _, tok_c = st_c["caption"](params_c, img_c)
    runs = {}
    for name, p, im in (("f32", params_c, img_c),
                        ("f64", tree_to(params_c, dtype=torch.float64), img_c.double())):
        with torch.no_grad():
            feat = cap.encode(p, im)
        r = st_c["decoder_lrp"](p, feat, tok)
        runs[name] = (r, st_c["cnn_lrp"](p, im, r[:, :CPU_WORDS]))
    cpu_s = time.perf_counter() - t0

    (r32, m32), (r64, m64) = runs["f32"], runs["f64"]
    out = dict(tokens_equal=bool(torch.equal(tok_c, tok)), cpu_s=cpu_s,
               r_feat_card_vs_cpu=worst(r_g, r32, T), maps_card_vs_cpu=worst(maps_g, m32, CPU_WORDS),
               r_feat_card_vs_f64=worst(r_g, r64, T), r_feat_cpu_vs_f64=worst(r32, r64, T),
               maps_card_vs_f64=worst(maps_g, m64, CPU_WORDS),
               maps_cpu_vs_f64=worst(m32, m64, CPU_WORDS))
    log(f"  {out}")
    if not out["tokens_equal"]:
        failures.append(f"tokens differ: card {tok.tolist()} cpu {tok_c.tolist()}")
    if out["maps_card_vs_cpu"] > TOL_CPU_MAPS:
        failures.append(f"card and CPU heatmaps differ beyond {TOL_CPU_MAPS} of their scale")
    for key, ratio in F64_RATIO.items():
        card, cpu = out[f"{key}_card_vs_f64"], out[f"{key}_cpu_vs_f64"]
        if card > max(ratio * cpu, 1e-5):
            failures.append(f"{key}: card deviates {card:.3e} from f64, CPU f32 {cpu:.3e}")
    return out


def phase_cpu_bf16(built, failures):
    """One image in bf16 on the card and on the CPU, and a CPU-f32 run as the
    anchor, all three on the card's tokens. The card-bf16 heatmaps must stay
    within BF16_CPU_RATIO times the CPU-bf16 run's distance from the anchor.

    The CPU-bf16 run's own tokens are recorded, not required equal: bf16
    features rounded in another summation order can flip a near-tie of the
    beam."""
    from lrp_imagecaptioning_torch.pipeline import build
    from lrp_imagecaptioning_torch.weights import tree_to

    fn, cap, cfg, params, images = built
    img = images[:1]
    st = fn.stages
    feat_g, tok_g = st["caption"](params, img)
    r_g = st["decoder_lrp"](params, feat_g, tok_g).cpu()
    maps_g = st["cnn_lrp"](params, img, r_g[:, :CPU_WORDS].to(img.device)).cpu()

    params_c, img_c, tok = tree_to(params, "cpu"), img.cpu(), tok_g.cpu()
    t0 = time.perf_counter()
    runs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        st_c = build(cfg, VOCAB, device="cpu", beam=BEAM, T=T, storage_dtype=dtype)[0].stages
        if dtype is None:
            with torch.no_grad():
                feat = cap.encode(params_c, img_c)
        else:
            feat, tok_c = st_c["caption"](params_c, img_c)
        r = st_c["decoder_lrp"](params_c, feat, tok)
        runs[name] = (r, st_c["cnn_lrp"](params_c, img_c, r[:, :CPU_WORDS]))
    cpu_s = time.perf_counter() - t0

    (r_bf, m_bf), (r32, m32) = runs["bf16"], runs["f32"]
    out = dict(tokens_equal=bool(torch.equal(tok_c, tok)), cpu_s=cpu_s,
               maps_card_vs_f32=worst(maps_g, m32, CPU_WORDS),
               maps_cpu_vs_f32=worst(m_bf, m32, CPU_WORDS),
               maps_card_vs_cpu_bf16=worst(maps_g, m_bf, CPU_WORDS),
               r_feat_card_vs_f32=worst(r_g, r32, T), r_feat_cpu_vs_f32=worst(r_bf, r32, T))
    out["maps_ratio"] = out["maps_card_vs_f32"] / out["maps_cpu_vs_f32"]
    log(f"  {out}")
    if not out["maps_ratio"] <= BF16_CPU_RATIO:
        failures.append(f"bf16 heatmaps: card deviates {out['maps_card_vs_f32']:.3e} from CPU f32, "
                        f"CPU bf16 {out['maps_cpu_vs_f32']:.3e} (limit {BF16_CPU_RATIO}x)")
    return out


# ---------------------------------------------------------------------------
# phases 6, 6b and 7: the training path
# ---------------------------------------------------------------------------


def train_batch(gen, dev, batch, steps=T_TRAIN):
    """Random images and captions of random lengths (half of ``steps`` to all
    of them, the EOS included), padded with 0: ``captions_in`` is SOS then the caption
    (0-based, teacher forcing), ``y_onehot`` the caption one-hot, all-zero
    rows after its end."""
    images = torch.randn(batch, IMAGE, IMAGE, 3, generator=gen, device=dev)
    words = torch.randint(3, VOCAB, (batch, steps), generator=gen, device=dev)
    lengths = torch.randint(steps // 2, steps + 1, (batch,), generator=gen, device=dev)
    live = torch.arange(steps, device=dev)[None, :] < lengths[:, None]
    words = torch.where(torch.arange(steps, device=dev)[None, :] == lengths[:, None] - 1,
                        EOS - 1, words) * live
    captions_in = torch.cat([torch.full((batch, 1), SOS - 1, device=dev), words[:, :-1]], dim=1)
    y = F.one_hot(words, VOCAB).float() * live[..., None]
    return images, captions_in, y


def expected_launches(path, cfg):
    """Each kernel's launches in one step, derived from the code: K2 once per
    decoder step of each forward (the train step's one; predict, the cached
    forward of lrp_weights and the dual loss's in a fine-tune step); K1 at the
    decoder LRP's output layer, gate-g block per step, W_glob and W_img; K3
    twice (divide, multiply) per post-ReLU conv per image."""
    from lrp_imagecaptioning_torch.models.vgg import vgg_layers

    steps = cfg.sentence_length + 1
    if path == "train":
        return {"lrp_linear": 0, "lstm_gates": steps, "conv3x3_fused": 0, "lrp_a1b0_fused": 0}
    convs = sum(op[0] == "conv" for op in vgg_layers(cfg.img_encoder, cfg.layer_name)) - 1
    return {"lrp_linear": steps + (5 if path == "aoa_finetune" else 3), "lstm_gates": 3 * steps,
            "conv3x3_fused": 2 * convs * cfg.batch_size, "lrp_a1b0_fused": 0}


def timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def counted_steps(step, n, params, state, batch, drop, want, failures, path):
    """``n`` steps, each with the counts set to 0 before it; every step must
    launch ``want``. Returns (params, state, per-step records)."""
    from lrp_imagecaptioning_torch.ops import kernels

    records = []
    for i in range(n):
        kernels.reset_launches()
        (params, state, m), ms = timed(step, params, state, *batch, drop)
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        records.append(dict(ms=ms, loss=float(m["loss"]), accuracy=float(m["accuracy"]),
                            launches=launches))
        log(f"  step {i}: {ms:.1f} ms  loss {records[-1]['loss']:.6f}  "
            f"accuracy {records[-1]['accuracy']:.4f}  launches {launches}")
        if launches != want:
            failures.append(f"{path} step {i}: launches {launches}, {want} expected")
        if not math.isfinite(records[-1]["loss"]):
            failures.append(f"{path} step {i}: loss {records[-1]['loss']}")
    return params, state, records


def memory_gib():
    return dict(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                reserved_gib=torch.cuda.max_memory_reserved() / 2**30)


def phase_train(dev, failures):
    """Three train steps on one batch of 32 (dropout 0.5, lr 2e-4, Adam with
    clipvalue 0.1), with the loss without dropout before and after them."""
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.train.optimizer import make_optimizer
    from lrp_imagecaptioning_torch.train.step import make_eval_step, make_train_step

    cfg = FlickrConfig()
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device=dev)
    batch = train_batch(torch.Generator(device=dev).manual_seed(2), dev, cfg.batch_size,
                        cfg.sentence_length + 1)
    opt = make_optimizer("adaptiveattention", cfg.learning_rate)
    evaluate = make_eval_step(cap)
    loss_before = float(evaluate(params, *batch)["loss"])
    want = expected_launches("train", cfg)
    torch.cuda.reset_peak_memory_stats()
    params, _, records = counted_steps(make_train_step(cap, opt), 3, params, opt.init(params),
                                       batch, torch.Generator(device=dev).manual_seed(3), want,
                                       failures, "train")
    mem = memory_gib()
    loss_after = float(evaluate(params, *batch)["loss"])
    steady = sum(r["ms"] for r in records[1:]) / (len(records) - 1)
    log(f"  eval loss (no dropout) {loss_before:.6f} -> {loss_after:.6f} after 3 steps; "
        f"{steady:.1f} ms a step after the first = {cfg.batch_size / steady * 1e3:.2f} img/s; "
        f"peak memory {mem['peak_gib']:.2f} GiB allocated, {mem['reserved_gib']:.2f} reserved")
    if not loss_after < loss_before:
        failures.append(f"train: eval loss {loss_before} -> {loss_after}, not lower")
    out = dict(batch=cfg.batch_size, drop_rate=cfg.drop_rate, lr=cfg.learning_rate,
               steps=records, ms_per_step=steady, img_per_s=cfg.batch_size / steady * 1e3,
               eval_loss_before=loss_before, eval_loss_after=loss_after, expected=want, **mem)
    return records[-1]["launches"], out


def phase_finetune(dev, failures):
    """Two LRP-inference fine-tune steps on one batch of 32 (mode 'mean', lr
    1e-6, every word explained), then the three phases of a third step timed
    apart (its update is discarded)."""
    import numpy as np

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.train.lrp_finetune import make_lrp_finetune_step
    from lrp_imagecaptioning_torch.train.optimizer import make_optimizer

    cfg = FlickrConfig()
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device=dev)
    batch = train_batch(torch.Generator(device=dev).manual_seed(4), dev, cfg.batch_size,
                        cfg.sentence_length + 1)
    drop = torch.Generator(device=dev).manual_seed(5)
    opt = make_optimizer("adaptiveattention", 1e-6)
    # no stop words: random weights predict any id, and every word is explained anyway
    step = make_lrp_finetune_step(cap, opt, np.zeros(VOCAB + 1, bool), SOS, EOS, "mean")
    want = expected_launches("finetune", cfg)
    torch.cuda.reset_peak_memory_stats()
    params, state, records = counted_steps(step, 2, params, opt.init(params), batch, drop,
                                           want, failures, "finetune")
    mem = memory_gib()
    ph = step.phases
    images, captions_in, y = batch
    y_pred, t_predict = timed(ph["predict"], params, images, captions_in)
    w, t_weights = timed(ph["lrp_weights"], params, images, y_pred)
    _, t_update = timed(ph["update"], params, state, images, captions_in, y, w, drop)
    split = dict(predict=t_predict, lrp_weights=t_weights, update=t_update)
    scored = int((w != 1.0).any(-1).sum())
    log(f"  {records[-1]['ms']:.1f} ms a step (the second) = "
        f"{cfg.batch_size / records[-1]['ms'] * 1e3:.2f} img/s; a third step's phases: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; {scored} of {w.shape[0] * w.shape[1]} (image, step) slots scored; peak memory "
        f"{mem['peak_gib']:.2f} GiB allocated, {mem['reserved_gib']:.2f} reserved")
    if not bool(torch.isfinite(w).all()):
        failures.append("finetune: relevance weights hold non-finite values")
    out = dict(batch=cfg.batch_size, mode="mean", lr=1e-6, steps=records,
               ms_per_step=records[-1]["ms"], img_per_s=cfg.batch_size / records[-1]["ms"] * 1e3,
               split_ms=split, scored_slots=scored, expected=want, **mem)
    return records[-1]["launches"], out


# phase 6c: K steps a call (--steps-per-call), each step the replay of one
# captured graph, against K chained eager steps at full width
K_TRAIN, K_FINETUNE = 4, 2
MULTI_REPS = 3              # timed graphed calls after the one that captures
# the graphed call's losses against the eager chain's, relative, with
# cuDNN's default algorithms: its weight gradients sum in a varying order,
# so from the second step on each side's loss is taken at params that
# Adam's sign-like first steps moved apart. An H100 80GB HBM3 at 700 W read
# 1.114e-6 graphed and 7.43e-7 for a second eager chain (train, K = 4, lr
# 2e-4), 0 for both (fine-tune, K = 2, lr 1e-6): about 9x the largest
TOL_MULTI_LOSS = 1e-5


def tree_distance(got, ref):
    """(leaves not bit for bit equal, of all; the largest |distance|; the
    2-norm of the distance over the reference's), over two trees."""
    from lrp_imagecaptioning_torch.weights import tree_leaves

    pairs = list(zip(tree_leaves(got), tree_leaves(ref)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    largest = max(float((a - b).abs().max()) for a, b in pairs)
    num = math.sqrt(sum(float((a.double() - b.double()).norm()) ** 2 for a, b in pairs))
    den = math.sqrt(sum(float(b.double().norm()) ** 2 for _, b in pairs))
    return differ, len(pairs), largest, num / max(den, 1e-30)


def phase_multi_step(dev, failures):
    """6c: ``make_multi_train_step`` at K = K_TRAIN and
    ``make_multi_lrp_finetune_step`` at K = K_FINETUNE, batch 32, each step
    replayed from one captured graph (``graphs.StepGraph``), against K
    chained eager steps from generators of one seed.

    With cuDNN's deterministic algorithms (``torch.backends.cudnn.
    deterministic``) the eager step repeats itself bit for bit, so the
    replay is held to it bit for bit: losses, params and moments, on a first
    call and on a second after ``set_learning_rate`` (the rate and the bias
    corrections read from the card, written by the host); the launches of
    the first held to K x one step's. With cuDNN's default algorithms, as a
    user trains, two eager chains already differ (its weight gradients sum
    in a varying order): the replay's distance from an eager chain is
    logged beside the second eager chain's, its losses held within
    TOL_MULTI_LOSS; ms a step (the median of MULTI_REPS calls, and of as
    many eager chains after a warm-up one), capture s, peak GiB and the
    host's share of a call are read there. Returns (launches by path, report)."""
    import numpy as np

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.train.lrp_finetune import (make_lrp_finetune_step,
                                                              make_multi_lrp_finetune_step)
    from lrp_imagecaptioning_torch.train.optimizer import make_optimizer, set_learning_rate
    from lrp_imagecaptioning_torch.train.step import (chain_steps, make_multi_train_step,
                                                      make_train_step)

    cfg = FlickrConfig()
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device=dev)
    stop = np.zeros(VOCAB + 1, bool)
    launches, rep = {}, {}
    for path, K, lr, seed in (("multi_train", K_TRAIN, cfg.learning_rate, 60),
                              ("multi_finetune", K_FINETUNE, 1e-6, 70)):
        opt = make_optimizer("adaptiveattention", lr)

        def steps():
            if path == "multi_train":
                return make_train_step(cap, opt), make_multi_train_step(cap, opt)
            return (make_lrp_finetune_step(cap, opt, stop, SOS, EOS, "mean"),
                    make_multi_lrp_finetune_step(cap, opt, stop, SOS, EOS, "mean"))

        gen = torch.Generator(device=dev).manual_seed(seed)
        stacks = [[torch.stack(x) for x in zip(*(train_batch(gen, dev, B_TRAIN, T_TRAIN)
                                                 for _ in range(K)))] for _ in range(2)]
        want = {k: K * v for k, v in expected_launches(path[6:], cfg).items()}
        drop = lambda: torch.Generator(device=dev).manual_seed(seed + 1)   # noqa: E731
        state0 = opt.init(params)
        r = rep[path] = dict(K=K, lr=lr, expected=want)

        # deterministic cuDNN: the replay against the eager chain, bit for bit
        torch.backends.cudnn.deterministic = True
        try:
            single, multi = steps()
            drop_e = drop()
            e1, t1, m1 = chain_steps(single, params, state0, stacks[0], drop_e)
            e2, t2, m2 = chain_steps(single, e1, set_learning_rate(t1, lr / 2), stacks[1], drop_e)
            multi(params, state0, *stacks[0], torch.Generator(device=dev).manual_seed(seed + 2))
            drop_m = drop()
            kernels.reset_launches()
            p1, s1, n1 = multi(params, state0, *stacks[0], drop_m)
            r["launches"] = counted = counts()
            held1 = (tree_distance(p1, e1), tree_distance([s1["mu"], s1["nu"]], [t1["mu"], t1["nu"]]),
                     torch.equal(n1["loss"], m1["loss"]))
            p2, s2, n2 = multi(p1, set_learning_rate(s1, lr / 2), *stacks[1], drop_m)
            held2 = (tree_distance(p2, e2), tree_distance([s2["mu"], s2["nu"]], [t2["mu"], t2["nu"]]),
                     torch.equal(n2["loss"], m2["loss"]))
            r.update(deterministic=dict(
                params=held1[0], moments=held1[1], losses_equal=held1[2],
                after_rate_params=held2[0], after_rate_moments=held2[1],
                after_rate_losses_equal=held2[2], count=[s1["count"], s2["count"]],
                losses=[n1["loss"].tolist(), n2["loss"].tolist()], captures=multi.graph.captures))
            del single, multi, e1, e2, t1, t2, p1, p2, s1, s2
        finally:
            torch.backends.cudnn.deterministic = False
        gc.collect()
        torch.cuda.empty_cache()

        # cuDNN's default algorithms, as a user trains: the spread and the times
        single, multi = steps()
        # the eager chain timed as the graphed calls are: after a warm-up
        # chain (the reference), the median of MULTI_REPS chains; the last
        # is the second eager chain held to the first
        ea, ta, ma = chain_steps(single, params, state0, stacks[0], drop())
        eager_reps = []
        for _ in range(MULTI_REPS):
            (eb, tb, mb), ms = timed(chain_steps, single, params, state0, stacks[0], drop())
            eager_reps.append(ms)
        eager_ms = float(np.median(eager_reps))
        parts = {}
        timed_method(multi.graph, "_capture", parts)
        torch.cuda.reset_peak_memory_stats()
        _, first_ms = timed(multi, params, state0, *stacks[0],
                            torch.Generator(device=dev).manual_seed(seed + 2))
        reps, hosts = [], []
        for _ in range(MULTI_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pg, sg, ng = multi(params, state0, *stacks[0], drop())
            hosts.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        mem = memory_gib()
        steady = float(np.median(reps))
        loss_rel = float(((ng["loss"] - ma["loss"]).abs() / ma["loss"].abs()).max())
        r.update(captures=multi.graph.captures, capture_s=parts["_capture"][0] / 1e3,
                 first_call_ms=first_ms, reps_ms=reps, reps_host_ms=hosts,
                 eager_reps_ms=eager_reps,
                 ms_per_step=steady / K, eager_ms_per_step=eager_ms / K,
                 host_share=float(np.median(hosts)) / steady, loss_rel=loss_rel,
                 graphed_vs_eager=dict(params=tree_distance(pg, ea),
                                       moments=tree_distance([sg["mu"], sg["nu"]],
                                                             [ta["mu"], ta["nu"]])),
                 eager_vs_eager=dict(params=tree_distance(eb, ea),
                                     moments=tree_distance([tb["mu"], tb["nu"]],
                                                           [ta["mu"], ta["nu"]]),
                                     loss_rel=float(((mb["loss"] - ma["loss"]).abs()
                                                     / ma["loss"].abs()).max())),
                 losses=ng["loss"].tolist(), eager_losses=ma["loss"].tolist(), **mem)
        d = r["deterministic"]
        log(f"  6c {path}, K = {K}, cuDNN deterministic: against the eager chain params "
            f"{d['params']} (leaves differing, of; largest; 2-norm rel), moments {d['moments']}, "
            f"losses equal {d['losses_equal']}; after set_learning_rate({lr / 2:g}): params "
            f"{d['after_rate_params']}, moments {d['after_rate_moments']}, losses equal "
            f"{d['after_rate_losses_equal']}; counts {d['count']}; launches {counted}")
        log(f"  6c {path}, K = {K}, cuDNN default: {steady / K:.2f} ms a step graphed (median of "
            f"{MULTI_REPS} calls; host {r['host_share']:.3f} of a call), {eager_ms / K:.2f} ms a "
            f"step eager chained (median of {MULTI_REPS} chains after a warm-up one); capture "
            f"{r['capture_s']:.2f} s (first call {first_ms:.1f} ms); "
            f"peak {mem['peak_gib']:.2f} GiB allocated, {mem['reserved_gib']:.2f} reserved; "
            f"losses {r['losses']} (eager {r['eager_losses']}, rel {loss_rel:.3e}); graphed "
            f"against eager {r['graphed_vs_eager']}, a second eager chain against the first "
            f"{r['eager_vs_eager']}")
        if counted != want:
            failures.append(f"6c {path}: launches {counted}, {want} derived (K x one step's)")
        if d["captures"] != 1 or r["captures"] != 1:
            failures.append(f"6c {path}: captures {d['captures']}, {r['captures']}; 1 expected")
        if d["count"] != [K, 2 * K]:
            failures.append(f"6c {path}: Adam counts {d['count']}, {[K, 2 * K]} expected")
        for label, pd, md, eq in (("first call", d["params"], d["moments"], d["losses_equal"]),
                                  ("after set_learning_rate", d["after_rate_params"],
                                   d["after_rate_moments"], d["after_rate_losses_equal"])):
            if pd[0] or md[0] or not eq:
                failures.append(f"6c {path} {label} (cuDNN deterministic): not bit for bit the "
                                f"eager chain's: params {pd}, moments {md}, losses equal {eq}")
        if loss_rel > TOL_MULTI_LOSS or not all(math.isfinite(v) for v in r["losses"]):
            failures.append(f"6c {path} (cuDNN default): losses {r['losses']}, eager "
                            f"{r['eager_losses']}")
        launches[path] = counted
        del single, multi, ea, eb, ta, tb, pg, sg
        gc.collect()
        torch.cuda.empty_cache()
    return launches, rep


def leaf_names(tree, prefix=""):
    """The '/'-joined key paths of a params tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def phase_finetune_cpu(dev, failures, batch_seed=6, mask_seed=7):
    """One fine-tune step's loss, gradients and relevance weights at batch 1
    without dropout, on the card, on the CPU in f32 and in f64, all on the
    card's predicted words. Gradients: the worst leaf's distance from f64
    over its scale; the card's may be FT_GRAD_RATIO times the CPU-f32 run's.
    Weights: within TOL_FT_WEIGHTS of their scale from f64. The gradients
    again with dropout ("_dropout" keys), on one set of masks drawn on the CPU
    at rate 0.5 and given to all three, each leaf held to the CPU-f32 run's
    distance on it by the 2-norm (TOL_FT_GRAD_L2_FLOOR). The seeds are the
    random batch's and the masks' (scripts/phase7_seeds.py varies them)."""
    import numpy as np

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.adaptive import draw_dropout_masks
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.train.lrp_finetune import dual_loss, make_lrp_finetune_step
    from lrp_imagecaptioning_torch.train.optimizer import make_optimizer
    from lrp_imagecaptioning_torch.train.step import value_and_grad
    from lrp_imagecaptioning_torch.weights import tree_leaves, tree_to

    cfg = FlickrConfig(drop_rate=0.0)
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device=dev)
    batch = train_batch(torch.Generator(device=dev).manual_seed(batch_seed), dev, 1,
                        cfg.sentence_length + 1)
    step = make_lrp_finetune_step(cap, make_optimizer("adaptiveattention", 1e-6),
                                  np.zeros(VOCAB + 1, bool), SOS, EOS, "mean")
    y_pred = step.phases["predict"](params, *batch[:2])
    params_c = tree_to(params, "cpu")
    masks = draw_dropout_masks(torch.Generator().manual_seed(mask_seed), params_c["decoder"], 1,
                               cfg, 0.5)

    def run(p, images, captions_in, y, logits, m):
        """(loss, grads) without dropout, the same with masks ``m``, weights."""
        w = step.phases["lrp_weights"](p, images, logits)
        out = []
        for mk in (None, m):
            loss, _, grads = value_and_grad(lambda q: (dual_loss(
                cap.forward_train(q, images, captions_in, None, masks=mk), w, y), None), p)
            out += [float(loss), [g.cpu().double() for g in tree_leaves(grads)]]
        return (*out, w.cpu().double())

    runs = {"card": run(params, *batch, y_pred, masks.to(dev))}
    t0 = time.perf_counter()
    cpu = [t.cpu() for t in (*batch, y_pred)]
    runs["f32"] = run(params_c, *cpu, masks)
    runs["f64"] = run(tree_to(params_c, dtype=torch.float64), cpu[0].double(), cpu[1],
                      cpu[2].double(), cpu[3].double(), masks.to(torch.float64))
    cpu_s = time.perf_counter() - t0
    loss64, g64, loss64_d, g64_d, w64 = runs["f64"]
    names = leaf_names(params_c)
    out = dict(cpu_s=cpu_s, loss={k: v[0] for k, v in runs.items()},
               loss_dropout={k: v[2] for k, v in runs.items()})
    l2 = {}
    for name in ("card", "f32"):
        loss, g, loss_d, g_d, w = runs[name]
        out[f"loss_{name}_vs_f64"] = abs(loss - loss64) / abs(loss64)
        out[f"loss_{name}_vs_f64_dropout"] = abs(loss_d - loss64_d) / abs(loss64_d)
        for sfx, got, ref in (("", g, g64), ("_dropout", g_d, g64_d)):
            # each leaf's max |diff| over its max |g|, and its 2-norm of the
            # difference over its 2-norm
            l2[name + sfx] = [((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                              for a, b in zip(got, ref)]
            out[f"grads_{name}_vs_f64{sfx}"], out[f"worst_leaf_{name}{sfx}"] = max(
                (rel_err(a, b)[1], n) for n, a, b in zip(names, got, ref))
            out[f"grads_l2_{name}_vs_f64{sfx}"], out[f"worst_l2_leaf_{name}{sfx}"] = max(
                zip(l2[name + sfx], names))
        out[f"weights_{name}_vs_f64"] = rel_err(w, w64)[1]
    out["leaves_over_dropout"] = [
        (n, card, cpu) for n, card, cpu in zip(names, l2["card_dropout"], l2["f32_dropout"])
        if card > max(FT_GRAD_RATIO * cpu, TOL_FT_GRAD_L2_FLOOR)]
    for sfx in ("", "_dropout"):
        out[f"grad_ratio{sfx}"] = (out[f"grads_card_vs_f64{sfx}"]
                                   / max(out[f"grads_f32_vs_f64{sfx}"], 1e-6))
    out["scored_equal"] = bool(torch.equal(runs["card"][-1] != 1.0, w64 != 1.0))
    log(f"  {out}")
    if out["grad_ratio"] > FT_GRAD_RATIO:
        failures.append(f"fine-tune gradients: card {out['grads_card_vs_f64']:.3e} from f64, "
                        f"CPU f32 {out['grads_f32_vs_f64']:.3e} (limit {FT_GRAD_RATIO}x)")
    if out["leaves_over_dropout"]:
        failures.append(f"fine-tune gradients with dropout: (leaf, card, CPU f32) 2-norm "
                        f"distances from f64 over {FT_GRAD_RATIO}x and {TOL_FT_GRAD_L2_FLOOR}: "
                        f"{out['leaves_over_dropout']}")
    if out["weights_card_vs_f64"] > TOL_FT_WEIGHTS or not out["scored_equal"]:
        failures.append(f"fine-tune weights: card {out['weights_card_vs_f64']:.3e} of scale from "
                        f"f64 (limit {TOL_FT_WEIGHTS}), same slots scored {out['scored_equal']}")
    return out


# ---------------------------------------------------------------------------
# phases 8, 8b, 8c and 8d: the Explainer
# ---------------------------------------------------------------------------

N_NATURAL = 224             # experiments/bench_natural.py: 224 images at batch 56
BUCKETS = (4, 8, 12, 16)    # the Explainer's default word buckets; T beyond them
CONVS = 12                  # post-ReLU VGG16 convs: K3 twice or K4 once each, per image
GRAD_METHODS = ("gradient", "input_times_gradient", "guided_backprop", "guided_gradcam",
                "deconvnet", "integrated_gradients", "smoothgrad")
# analyze / analyze_batch / analyze_many on the same images: each array's
# largest distance over its scale. They run the cached forward at other
# batch sizes, and cuBLAS sums a product of one row in another order than one
# of four (scripts/explainer_consistency.py: the encode and the decoder LRP
# on the same caches agree, K1's split-K plays no part). The decoder LRP's
# outputs (feat_relevance, word_relevances) divide by z +- 1e-7, which
# amplifies those ~1e-7 differences, as f32 rounding does: at full width it
# alone puts feat_relevance 1.3e-4 to 5.3e-3 of its scale from f64 (phases
# 4, 8b, 8c and the script's five images), so they are held to
# TOL_CONSISTENT_LRP, inside that range. The decoder LRP itself
# is held to TOL_CONSISTENT on one set of caches (``lrp_on_shared_caches``).
# In bf16 storage a difference can flip one bf16 rounding of a heatmap value
# (2^-8 of it): its maps are held to the bf16 rule's kernel tolerance. Every
# other array, and the f32 heatmaps, to TOL_CONSISTENT
TOL_CONSISTENT = 1e-4
TOL_CONSISTENT_LRP = 1e-3
EXPLANATION_FIELDS = ("relevance_maps", "feat_relevance", "attentions", "word_relevances",
                      "betas")
# phase 8d holds each method's CNN side to CPU f32 and f64 runs of the same
# function on one shared seed, by the 2-norm of the difference over the f64
# map's. A ReLU or a max-pool that a near-tie flips between two forwards
# moves single values by up to 5 % of the map's largest (each run's largest
# distance is logged beside) and up to 7.6e-3 of its norm: an H100 80GB HBM3
# at 700 W read the CPU-f32 runs 1.4e-6 to 6.4e-3 from f64 and the card
# 7.7e-5 to 7.6e-3 (scripts/explainer_consistency.py), deconvnet 1.8e-3
# where its CPU-f32 run had no flip. The card must lie within
# GRAD_MAPS_RATIO times the CPU-f32 run's distance, or GRAD_MAPS_FLOOR: a
# CNN gradient a few % off fails
GRAD_MAPS_RATIO = 2.0
GRAD_MAPS_FLOOR = 1e-2


class CaptionPP:
    """The caption preprocessor's surface the Explainer reads, vocab 7003."""

    SOS_TOKEN, EOS_TOKEN = "szeros", "zeros"
    SOS_TOKEN_LABEL_ENCODED, EOS_TOKEN_LABEL_ENCODED = SOS, EOS
    word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}


def natural_workload():
    """bench_natural.py's workload from numpy seed 0: 224 normal images, then
    caption lengths clip(round(N(10, 3)), 4, 20) and random words, EOS after."""
    import numpy as np

    rng = np.random.default_rng(0)
    images = rng.normal(size=(N_NATURAL, IMAGE, IMAGE, 3)).astype(np.float32)
    lengths = np.clip(np.round(rng.normal(10.0, 3.0, size=N_NATURAL)), 4, T).astype(int)
    toks = np.zeros((N_NATURAL, T), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(3, VOCAB, size=n)
        if n < T:
            toks[i, n] = EOS
    return images, toks, lengths


def bucket_for(n_words):
    return next((w for w in BUCKETS if n_words <= w), T)


def sorted_plan(n_words, batch):
    """analyze_many's dispatch, derived here: images sorted by caption length
    (stable), chunks of ``batch``, each on the bucket of its longest caption
    -> [(images, bucket)]."""
    import numpy as np

    order = np.argsort(np.asarray(n_words), kind="stable")
    return [(len(order[i:i + batch]), bucket_for(int(np.asarray(n_words)[order[i:i + batch]].max())))
            for i in range(0, len(order), batch)]


def explain_launches(model_type, storage_dtype, plan, decodes=0, method="lrp", cfg=None):
    """Each kernel's launches for ``decodes`` beam searches and the explain
    calls of ``plan`` [(rows, bucket)], derived from the code: K2 once
    (adaptive, AOA) or twice (grid-TD) a step of every beam search and cached
    forward; for lrp, deep_taylor and deep_lift K1 at the LRP's output layer,
    gate blocks a step (one or two), W_glob and W_img (AOA: the GLU, v_proj,
    q_proj and image_features), whatever the bucket; K3 twice per conv of
    ``k3_layers(cfg)`` (default VGG16's 12) per image for f32 lrp and, on
    VGG, for deep_taylor whatever the storage; K4 once (lrp in bf16, VGG
    only: the other encoders' walks stay f32) per post-ReLU conv per image (a
    dispatch's padded rows skip the CNN side). deep_lift's CNN side, ResNet's
    and Inception's deep_taylor and the gradient methods run no K3 or K4
    (torch ops, cuDNN), the gradient methods no K1."""
    lstms = 2 if model_type == "gridTD" else 1
    convs = CONVS if cfg is None else len(k3_layers(cfg))
    vgg = cfg is None or cfg.img_encoder.startswith("vgg")
    out = {"lrp_linear": 0, "lstm_gates": lstms * T * decodes, "conv3x3_fused": 0,
           "lrp_a1b0_fused": 0}
    for rows, _ in plan:
        out["lstm_gates"] += lstms * T
        if method in ("lrp", "deep_taylor", "deep_lift"):
            out["lrp_linear"] += T + 5 if model_type == "aoa" else lstms * T + 3
        if (method == "deep_taylor" and vgg) or (method == "lrp" and (storage_dtype is None
                                                                      or not vgg)):
            out["conv3x3_fused"] += 2 * convs * rows
        elif method == "lrp":
            out["lrp_a1b0_fused"] += convs * rows
    return out


def counts():
    from lrp_imagecaptioning_torch.ops import kernels

    return {k.__name__: k.launches for k in kernels.KERNELS}


def pool_gib(ex):
    """The Explainer's graph pool: the device memory segments it holds."""
    return ex.graphs.pool_bytes() / 2**30


def explanation_dist(got, ref):
    """For each Explanation array, the largest distance of ``got``'s from
    ``ref``'s over that array's scale; inf where the words differ."""
    worst = dict.fromkeys(EXPLANATION_FIELDS, 0.0)
    for g, r in zip(got, ref):
        if g.words != r.words or g.caption != r.caption:
            return dict.fromkeys(EXPLANATION_FIELDS, float("inf"))
        for name in EXPLANATION_FIELDS:
            a, b = getattr(g, name), getattr(r, name)
            if b.size:
                scale = max(float(abs(b).max()), 1e-30)
                worst[name] = max(worst[name], float(abs(a - b).max()) / scale)
    return worst


def lrp_on_shared_caches(ex, images, toks):
    """The decoder backward of each image alone (batch 1) and of all of them
    (batch n), on the caches of one cached forward at batch n: each output's
    largest distance over its scale."""
    with torch.no_grad():
        n = len(images)
        tokens = torch.as_tensor(toks[:n], dtype=torch.long, device=images.device)
        consts, caches = ex.captioner.cached_forward(ex.params, ex._encode(images), tokens, SOS)
        pos = torch.arange(T, device=images.device).expand(n, T).contiguous()
        words0 = torch.clamp(tokens - 1, min=0)
        full = ex._backward(ex.params["decoder"], consts, caches, words0, pos)
        worst = {}
        for b in range(n):
            one = ex._backward(ex.params["decoder"], type(consts)(*(c[b:b + 1] for c in consts)),
                               type(caches)(*(c[:, b:b + 1] for c in caches)), words0[b:b + 1],
                               pos[b:b + 1])
            for name, a, ref in zip(("feat_relevance", "word_relevances", "attentions"), one, full):
                d = float((a[0] - ref[b]).abs().max() / ref[b].abs().max().clamp_min(1e-30))
                worst[name] = max(worst.get(name, 0.0), d)
    return worst


def check_entry_points(ex, images, toks, label, failures, maps_tol=TOL_CONSISTENT):
    """analyze, analyze_batch and analyze_many on the same three images and
    tokens: the heatmaps within ``maps_tol`` of their scale, the decoder
    LRP's outputs within TOL_CONSISTENT_LRP, the rest within TOL_CONSISTENT;
    the decoder LRP at batch 1 and 3 on one cached forward's caches within
    TOL_CONSISTENT. Batch 1 and 3 capture graphs of their own."""
    tol = dict.fromkeys(EXPLANATION_FIELDS, TOL_CONSISTENT)
    tol.update(relevance_maps=maps_tol, feat_relevance=TOL_CONSISTENT_LRP,
               word_relevances=TOL_CONSISTENT_LRP)
    one = [ex.analyze(images[i], toks[i]) for i in range(3)]
    batch = ex.analyze_batch(images[:3], toks[:3])
    many = ex.analyze_many(images[:3], toks[:3], 3)
    rep = dict(batch_vs_analyze=explanation_dist(batch, one),
               many_vs_analyze=explanation_dist(many, one))
    rep["lrp_shared_caches"] = lrp_on_shared_caches(ex, images[:3], toks)
    log(f"  {label}: analyze vs analyze_batch vs analyze_many, 3 images, and the decoder LRP "
        f"at batch 1 and 3 on shared caches: {rep}")
    for key, dist in rep.items():
        bad = {f: d for f, d in dist.items()
               if d > (TOL_CONSISTENT if key == "lrp_shared_caches" else tol[f])}
        if bad:
            failures.append(f"{label}: the entry points disagree ({key}): {bad}")
    return rep


def check_explanations(out, n_words, label, failures, nonzero=True, size=IMAGE, finite=True):
    """Shapes (``size`` x ``size`` maps), finiteness (``finite``) and
    (``nonzero``) a map that is not all zero for every explained word."""
    bad = [i for i, (e, n) in enumerate(zip(out, n_words))
           if len(e.words) != n or e.relevance_maps.shape != (n, size, size, 3)
           or (finite and not (abs(e.relevance_maps) < float("inf")).all())
           or (nonzero and n and not (abs(e.relevance_maps).reshape(n, -1).max(axis=1) > 0).all())]
    if bad:
        failures.append(f"{label}: explanations {bad[:5]} have the wrong words, shape, "
                        f"non-finite or all-zero maps")


def explainer_for(cap, params, dev, pp=None, **kw):
    from lrp_imagecaptioning_torch.explain.engine import Explainer

    return Explainer(cap, params, pp or CaptionPP(), beam_size=BEAM, word_buckets=BUCKETS,
                     device=dev, **kw)


def explain_split(ex, images, toks_np, W):
    """Where one explain call over ``images`` on bucket ``W`` spends its time:
    ms of the encode, the decoder stage (a graph replay), the CNN side, the
    copy of the outputs to the host and the assembly of the Explanations, each
    by the host clock around a synchronised call; and the outputs' GiB."""
    toks = torch.as_tensor(toks_np, dtype=torch.long, device=images.device)
    positions = torch.arange(W, device=images.device).expand(len(images), W).contiguous()
    with torch.no_grad():
        feat, encode = timed(ex._encode, images)
        dec, decoder = timed(ex._slots[0].decoder, ex.params, feat, toks, positions)
        maps, cnn = timed(ex._cnn, images, feat, dec[0])
    host, to_host = timed(lambda: [o.float().cpu().numpy() for o in (maps, *dec)])
    _, assemble = timed(lambda: [ex._assemble(toks_np, host, b) for b in range(len(images))])
    return dict(bucket=W, encode=encode, decoder=decoder, cnn=cnn, to_host=to_host,
                assemble=assemble, host_gib=sum(h.nbytes for h in host) / 2**30)


def phase_explainer(dev, failures):
    """The Explainer at bench_natural's workload: adaptive attention, bf16
    storage, 224 images with natural caption lengths at batch 56."""
    import numpy as np

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.ops import kernels

    cap = build_captioner("adaptiveattention", FlickrConfig(), VOCAB)
    params = cap.init_params(seed=0, device=dev)
    images_np, toks, lengths = natural_workload()
    images = torch.from_numpy(images_np).to(dev)
    del images_np
    ex = explainer_for(cap, params, dev, storage_dtype=torch.bfloat16, batch_size=B_BF16)

    _, warm_ms = timed(ex.warmup, images[:B_BF16])
    captures = ex.graphs.captures
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, ms = timed(ex.analyze_many, images, toks, B_BF16)
    launches, mem = counts(), memory_gib()
    plan = sorted_plan(lengths, B_BF16)
    want = explain_launches("adaptiveattention", torch.bfloat16, plan)
    check_explanations(out, lengths, "phase 8 analyze_many", failures)
    host_gib = sum(e.relevance_maps.nbytes for e in out) / 2**30
    del out
    rep = dict(images=N_NATURAL, batch=B_BF16, mean_words=float(lengths.mean()), warm_ms=warm_ms,
               ms=ms, img_per_s=N_NATURAL / ms * 1e3, plan=plan, launches=launches, expected=want,
               captures_after_warmup=captures, captures_after_request=ex.graphs.captures,
               pool_gib=pool_gib(ex), graph_outputs_gib=ex.graphs.output_bytes() / 2**30,
               host_maps_gib=host_gib, **mem)
    log(f"  warm-up {warm_ms:.1f} ms ({captures} graph captures); analyze_many over "
        f"{N_NATURAL} images ({rep['mean_words']:.2f} words an image): {ms:.1f} ms = "
        f"{rep['img_per_s']:.2f} img/s; chunks (rows, bucket) {plan}; captures "
        f"{captures} -> {ex.graphs.captures}; graph pool {rep['pool_gib']:.3f} GiB, its "
        f"outputs {rep['graph_outputs_gib']:.3f} GiB; peak {mem['peak_gib']:.2f} GiB "
        f"allocated, {mem['reserved_gib']:.2f} reserved; maps on the host {host_gib:.3f} GiB")
    log(f"  launches {launches}")
    if launches != want:
        failures.append(f"phase 8: launches {launches}, {want} derived from the plan")
    # the split of the shortest and the longest sorted chunk's explain call
    order = np.argsort(lengths, kind="stable")
    rep["split"] = [explain_split(ex, images[torch.as_tensor(sel, device=dev)], toks[sel],
                                  bucket_for(int(lengths[sel].max())))
                    for sel in (order[:B_BF16], order[-B_BF16:])]
    log(f"  one chunk's explain call by part, ms (shortest and longest chunk): {rep['split']}")
    if ex.graphs.captures != captures:
        failures.append(f"phase 8: a request captured after warm-up ({captures} -> "
                        f"{ex.graphs.captures})")

    # the decode: analyze_many without tokens over one chunk
    kernels.reset_launches()
    out, ms_d = timed(ex.analyze_many, images[:B_BF16], None, B_BF16)
    words = np.asarray([len(e.words) for e in out])
    want_d = explain_launches("adaptiveattention", torch.bfloat16, sorted_plan(words, B_BF16), 1)
    check_explanations(out, words, "phase 8 decode", failures)
    rep.update(decode_ms=ms_d, decode_img_per_s=B_BF16 / ms_d * 1e3, decode_launches=counts(),
               decode_expected=want_d, decode_words=words.tolist()[:8],
               captures_after_decode=ex.graphs.captures)
    log(f"  analyze_many decoding {B_BF16} images: {ms_d:.1f} ms = {rep['decode_img_per_s']:.2f} "
        f"img/s; words {words.tolist()[:8]}...; launches {rep['decode_launches']}; captures "
        f"{ex.graphs.captures}")
    if rep["decode_launches"] != want_d or ex.graphs.captures != captures:
        failures.append(f"phase 8 decode: launches {rep['decode_launches']} ({want_d} derived), "
                        f"captures {captures} -> {ex.graphs.captures}")
    del out

    # the latency mode: every size of the halving ladder captured, then
    # requests of other sizes (split by bucket, decoded, past the batch)
    # replay those graphs: no capture, the pool as it was
    _, rep["warm_sub_ms"] = timed(ex.warmup, images[:B_BF16], True)
    rep["captures_sub"], rep["pool_sub_gib"] = ex.graphs.captures, pool_gib(ex)
    for k in (1, 5, 23, 60):
        ex.analyze_many(images[:k], toks[:k], split_buckets=True)
    for k in (2, 9):
        ex.analyze_batch(images[:k])
    rep["captures_sub_after"], rep["pool_sub_after_gib"] = ex.graphs.captures, pool_gib(ex)
    log(f"  warmup(sub_batches=True) {rep['warm_sub_ms']:.1f} ms: captures {rep['captures_sub']}, "
        f"pool {rep['pool_sub_gib']:.3f} GiB; after requests of 1-60 images "
        f"{rep['captures_sub_after']}, {rep['pool_sub_after_gib']:.3f} GiB")
    if (rep["captures_sub_after"], rep["pool_sub_after_gib"]) != (rep["captures_sub"],
                                                                  rep["pool_sub_gib"]):
        failures.append("phase 8: a request of another size captured or grew the pool after "
                        "warmup(sub_batches=True)")

    rep["consistency"] = check_entry_points(ex, images, toks, "phase 8", failures,
                                            maps_tol=TOL_BF16_KERNEL)
    return rep


def card_vs_cpu(ex, cap, params, image, tokens, failures, label, words=CPU_WORDS, caption=None,
                floor=F64_FLOOR):
    """One image on the card (``ex``), and on the CPU in f32 and in f64, with
    ``caption`` (default ``tokens``) cut to its first ``words`` words (the CPU
    time): the card's maps must lie within F64_RATIO times the CPU-f32 run's
    distance from f64 (floor F64_FLOOR of the scale), and ``tokens``, the
    card's decode, must equal the CPU's beam search."""
    from lrp_imagecaptioning_torch.explain.engine import _n_explained
    from lrp_imagecaptioning_torch.weights import tree_to
    import numpy as np

    params_c = tree_to(params, "cpu")
    caption = tokens if caption is None else caption
    n = min(_n_explained(caption, EOS), words)
    cut = np.zeros(T, np.int32)
    cut[:n] = caption[:n]
    cut[n] = EOS
    card = ex.analyze(image, cut)
    t0 = time.perf_counter()
    runs = {}
    for name, p in (("f32", params_c), ("f64", tree_to(params_c, dtype=torch.float64))):
        cpu = explainer_for(cap, p, "cpu", pp=ex._pp, method=ex.method)
        cpu._buckets = (n,)
        if name == "f32":
            cpu_tokens = cpu.predict_caption(image.cpu())[0]
        runs[name] = cpu.analyze(image.cpu(), cut)
    out = dict(cpu_s=time.perf_counter() - t0, words=n,
               tokens_equal=bool(np.array_equal(cpu_tokens, tokens)))
    for key, field in (("r_feat", "feat_relevance"), ("maps", "relevance_maps")):
        ref = getattr(runs["f64"], field)
        scale = max(float(abs(ref).max()), 1e-30)
        out[f"{key}_card_vs_f64"] = float(abs(getattr(card, field) - ref).max()) / scale
        out[f"{key}_cpu_vs_f64"] = float(abs(getattr(runs["f32"], field) - ref).max()) / scale
        if out[f"{key}_card_vs_f64"] > max(F64_RATIO[key] * out[f"{key}_cpu_vs_f64"],
                                           floor[key]):
            failures.append(f"{label} {key}: card deviates {out[f'{key}_card_vs_f64']:.3e} "
                            f"from f64, CPU f32 {out[f'{key}_cpu_vs_f64']:.3e}")
    if not out["tokens_equal"]:
        failures.append(f"{label}: card tokens {tokens.tolist()} != CPU {cpu_tokens.tolist()}")
    log(f"  {label} card vs CPU: {out}")
    return out


def explain_batch_run(cap, params, dev, images, storage_dtype, label, failures, method="lrp",
                      pp=None):
    """warmup, then one counted and timed analyze_batch (decode + explain)."""
    from lrp_imagecaptioning_torch.ops import kernels

    ex = explainer_for(cap, params, dev, pp=pp, storage_dtype=storage_dtype,
                       batch_size=len(images), method=method)
    _, warm_ms = timed(ex.warmup, images)
    captures = ex.graphs.captures
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, ms = timed(ex.analyze_batch, images)
    launches, mem = counts(), memory_gib()
    words = [len(e.words) for e in out]
    plan = [(len(images), bucket_for(max(words)))]
    want = explain_launches(cap.model_type, storage_dtype, plan, decodes=1, method=method,
                            cfg=cap.cfg)
    check_explanations(out, words, label, failures, size=images.shape[1])
    rep = dict(batch=len(images), storage_dtype=str(storage_dtype), warm_ms=warm_ms, ms=ms,
               img_per_s=len(images) / ms * 1e3, words=words, plan=plan, launches=launches,
               expected=want, captures=[captures, ex.graphs.captures], pool_gib=pool_gib(ex),
               graph_outputs_gib=ex.graphs.output_bytes() / 2**30, **mem)
    log(f"  {label}: analyze_batch of {len(images)}: {ms:.1f} ms = {rep['img_per_s']:.2f} img/s "
        f"(bucket {plan[0][1]}, words {words}); warm-up {warm_ms:.1f} ms; launches {launches}; "
        f"captures {rep['captures']}; pool {rep['pool_gib']:.3f} GiB; peak {mem['peak_gib']:.2f} "
        f"GiB allocated, {mem['reserved_gib']:.2f} reserved")
    if launches != want:
        failures.append(f"{label}: launches {launches}, {want} derived")
    if ex.graphs.captures != captures:
        failures.append(f"{label}: analyze_batch captured after warm-up")
    return ex, out, rep


def phase_explainer_f32(dev, failures):
    """The f32 Explainer at batch 8 (decode + explain), its three entry points
    on three of the images, then one image on the card against the CPU."""
    import numpy as np

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner

    cap = build_captioner("adaptiveattention", FlickrConfig(), VOCAB)
    params = cap.init_params(seed=0, device=dev)
    images = torch.from_numpy(natural_workload()[0][:B_MAIN]).to(dev)
    ex, out, rep = explain_batch_run(cap, params, dev, images, None, "phase 8b f32", failures)
    rep["consistency"] = check_entry_points(ex, images, np.stack([e.tokens_1based for e in out]),
                                            "phase 8b", failures)
    rep["cpu"] = card_vs_cpu(ex, cap, params, images[0], out[0].tokens_1based, failures,
                             "phase 8b")
    return rep


def phase_gridtd(dev, failures):
    """grid-TD lrp: f32 at batch 8 and bf16 at batch 56, each one counted
    analyze_batch; one image on the card against the CPU (f32)."""
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner

    cap = build_captioner("gridTD", FlickrConfig(), VOCAB)
    params = cap.init_params(seed=0, device=dev)
    images = torch.from_numpy(natural_workload()[0][:B_BF16]).to(dev)
    reps, launches = {}, {}
    for path, storage in (("gridtd_f32", None), ("gridtd_bf16", torch.bfloat16)):
        _, batch, _ = PATHS[path]
        ex, out, reps[path] = explain_batch_run(cap, params, dev, images[:batch], storage,
                                                f"phase 8c {path}", failures)
        launches[path] = reps[path]["launches"]
        if storage is None:
            reps["cpu"] = card_vs_cpu(ex, cap, params, images[0], out[0].tokens_1based,
                                      failures, "phase 8c")
        del ex, out
        gc.collect()
        torch.cuda.empty_cache()
    return launches, reps


def grad_vs_cpu(ex, cap, params, image, tokens, e, failures, label="phase 8d"):
    """The timed card Explainer ``ex`` (IG 16 steps, SmoothGrad 8 samples)
    against CPU f32 and f64 runs on the first word. The decoder gradient: the
    card's in the timed Explanation ``e``, the CPU runs' from their own
    encode; within F64_RATIO["r_feat"] times the CPU-f32 run's distance from
    f64 (floor F64_FLOOR). The CNN side: ``ex._cnn`` and the CPU runs' on one
    shared seed, the f64 run's decoder gradient, so that a ReLU mask the
    CPU-f32 decoder flips does not widen the bound; by the 2-norm, within
    GRAD_MAPS_RATIO times the CPU-f32 run's distance from f64 (floor
    GRAD_MAPS_FLOOR)."""
    from lrp_imagecaptioning_torch.weights import tree_to

    t0 = time.perf_counter()
    params_c = tree_to(params, "cpu")
    seed = torch.zeros(1, 1, dtype=torch.long)
    toks = torch.as_tensor(tokens[None], dtype=torch.long)
    runs = {}
    with torch.no_grad():
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            cpu = explainer_for(cap, tree_to(params_c, dtype=dtype), "cpu", pp=ex._pp,
                                method=ex.method)
            img = image.cpu().to(dtype)[None]
            feat = cpu._encode(img)
            r_feat = cpu._slots[0].decoder(cpu.params, feat, toks, seed)[0]       # (1, 1, L, D)
            runs[name] = dict(r_feat=r_feat[0, 0], cpu=cpu, img=img, feat=feat)
        r64 = runs["f64"]["r_feat"]
        for run in runs.values():
            run["maps"] = run["cpu"]._cnn(run["img"], run["feat"],
                                          r64.to(run["img"].dtype)[None, None])[0, 0]
        img = image[None]
        card_maps = ex._cnn(img, ex._encode(img), r64.to(image.device, image.dtype)[None, None])
    card = dict(r_feat=torch.from_numpy(e.feat_relevance[0]).double(),
                maps=card_maps[0, 0].cpu().double())
    out = dict(cpu_s=time.perf_counter() - t0)
    for key in ("r_feat", "maps"):
        ref = runs["f64"][key]
        scale, norm = max(float(ref.abs().max()), 1e-30), max(float(ref.norm()), 1e-30)
        for name, got in (("card", card[key]), ("cpu", runs["f32"][key].double())):
            out[f"{key}_{name}_vs_f64"] = float((got - ref).abs().max()) / scale
            out[f"{key}_{name}_vs_f64_l2"] = float((got - ref).norm()) / norm
    out["maps_card_vs_cpu_l2"] = float((card["maps"] - runs["f32"]["maps"].double()).norm()) / max(
        float(runs["f64"]["maps"].norm()), 1e-30)
    # the decoder gradient by the largest distance, the CNN side by the 2-norm
    for key, suffix, ratio, floor in (("r_feat", "", F64_RATIO["r_feat"], F64_FLOOR["r_feat"]),
                                      ("maps", "_l2", GRAD_MAPS_RATIO, GRAD_MAPS_FLOOR)):
        got, cpu = out[f"{key}_card_vs_f64{suffix}"], out[f"{key}_cpu_vs_f64{suffix}"]
        if got > max(ratio * cpu, floor):
            failures.append(f"{label} {ex.method} {key}: card deviates {got:.3e} from f64 "
                            f"({suffix or 'largest'}), CPU f32 {cpu:.3e}")
    log(f"  {label} {ex.method} card vs CPU, word 0 (maps on the f64 seed): {out}")
    return out


def walk_vs_cpu(ex, cap, params, image, tokens, failures, label, words, check_tokens):
    """10a: one image with ``tokens`` cut to its first ``words`` words, on
    the card (``ex``, eager, batch 1) and on the CPU in f32, each against the
    f64 walk over its own forward (TOL_WALK above), and an f64 run of its
    own. The CNN side of every run takes the f64 run's decoder relevance;
    DeepTaylor's maps are held by the largest distance (F64_RATIO["maps"]),
    DeepLIFT's by the 2-norm (GRAD_MAPS_RATIO). With ``check_tokens`` the
    card's decode must equal the CPU's beam search."""
    import numpy as np

    from lrp_imagecaptioning_torch.explain import cnn_lrp
    from lrp_imagecaptioning_torch.explain.cnn_deeplift import (_deeplift_backward,
                                                                reference_image)
    from lrp_imagecaptioning_torch.explain.engine import _n_explained
    from lrp_imagecaptioning_torch.models.vgg import vgg_apply_with_acts, vgg_layers
    from lrp_imagecaptioning_torch.weights import tree_to

    def f64(t):
        return t.detach().cpu().double()

    def promote(tup):
        return type(tup)(*(f64(x) if x.is_floating_point() else x.cpu() for x in tup))

    def l2(got, ref):
        return float((f64(got) - ref).norm()) / max(float(ref.norm()), 1e-30)

    n = min(_n_explained(tokens, EOS), words)
    cut = np.zeros(T, np.int32)
    cut[:n] = tokens[:n]
    cut[n] = EOS
    cfg = cap.cfg
    params_c = tree_to(params, "cpu")
    p64 = tree_to(params_c, dtype=torch.float64)
    cpu64 = explainer_for(cap, p64, "cpu", pp=ex._pp, method=ex.method)
    runs = {"card": ex, "cpu": explainer_for(cap, params_c, "cpu", pp=ex._pp, method=ex.method)}

    def decoder(run, img):
        """features, the decoder LRP of the cut's words, and its f64
        recursion over the same caches."""
        toks = torch.as_tensor(cut[None], dtype=torch.long, device=img.device)
        pos = torch.arange(n, device=img.device)[None]
        words0 = torch.clamp(toks - 1, min=0).gather(1, pos)
        feat = run._encode(img)
        consts, caches = cap.cached_forward(run.params, feat, toks, SOS)
        r = run._backward(run.params["decoder"], consts, caches, words0, pos)[0]
        r_own = cpu64._backward(p64["decoder"], promote(consts), promote(caches), words0.cpu(),
                                pos.cpu())[0]
        return feat, r, r_own

    t0 = time.perf_counter()
    out = {"words": n}
    with torch.no_grad():
        if check_tokens:
            cpu_tokens = runs["cpu"].predict_caption(image.cpu())[0]
            out["tokens_equal"] = bool(np.array_equal(cpu_tokens, tokens))
        img64 = f64(image)[None]
        feat64, r64, _ = decoder(cpu64, img64)
        maps64 = cpu64._cnn(img64, feat64, r64)
        for name, run in runs.items():
            img = image.to(run.device)[None]
            feat, r, r_own = decoder(run, img)
            out[f"feat_{name}_vs_f64"] = rel_err(f64(feat), feat64)[1]
            out[f"r_feat_{name}_walk"] = rel_err(f64(r), r_own)[1]
            out[f"r_feat_{name}_vs_f64"] = rel_err(f64(r), r64)[1]
            seed = r64.to(img.device, img.dtype)
            maps = run._cnn(img, feat, seed)
            out[f"maps_{name}_vs_f64"] = rel_err(f64(maps), maps64)[1]
            out[f"maps_{name}_vs_f64_l2"] = l2(maps, maps64)
            # the CNN walk over this run's own forward, in f64
            vgg, until, arch = run.params["vgg"], cfg.layer_name, cfg.img_encoder
            g = math.isqrt(seed.shape[2])
            seed64 = f64(seed).reshape(n, g, g, -1)
            top, acts = vgg_apply_with_acts(vgg, img, arch, until)
            if ex.method == "deep_lift":
                top_ref, acts_ref = vgg_apply_with_acts(vgg, reference_image(img, 0.0), arch,
                                                        until)
                own = _deeplift_backward(p64["vgg"], seed64, vgg_layers(arch, until),
                                         [f64(a) for a in acts], [f64(a) for a in acts_ref],
                                         f64(top), f64(top_ref), True)
                out[f"maps_{name}_walk_l2"] = l2(maps[0], own)
            else:
                own = cnn_lrp._backward(p64["vgg"], [f64(a) for a in acts], torch.relu(seed64),
                                        arch, until, cnn_lrp.conv_rule)
                out[f"maps_{name}_walk"] = rel_err(f64(maps[0]), own)[1]
    out["cpu_s"] = time.perf_counter() - t0
    gates = [("feat", "_vs_f64", F64_RATIO["r_feat"], TOL_WALK),
             ("r_feat", "_walk", F64_RATIO["r_feat"], TOL_WALK)]
    if ex.method == "deep_lift":
        gates.append(("maps", "_walk_l2", GRAD_MAPS_RATIO, TOL_WALK))
    else:
        gates.append(("maps", "_walk", F64_RATIO["maps"], TOL_WALK))
    for key, suffix, ratio, floor in gates:
        got, cpu = out[f"{key}_card{suffix}"], out[f"{key}_cpu{suffix}"]
        if got > max(ratio * cpu, floor):
            failures.append(f"{label} {key}: the card lies {got:.3e} from f64 ({suffix[1:]}), "
                            f"CPU f32 {cpu:.3e}, floor {floor:.1e}")
    if check_tokens and not out["tokens_equal"]:
        failures.append(f"{label}: card tokens {tokens.tolist()} != CPU {cpu_tokens.tolist()}")
    log(f"  {label} card vs CPU, {n} words (the CNN side on the f64 seed): {out}")
    return out


def phase_gradients(dev, failures):
    """Each gradient method on one image with a given 4-word caption: ms of a
    warmed analyze call and its launches (K2 in the cached forward only),
    then the same Explainer against the CPU on the first word."""
    import numpy as np

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.ops import kernels

    cap = build_captioner("adaptiveattention", FlickrConfig(), VOCAB)
    params = cap.init_params(seed=0, device=dev)
    images_np, toks, lengths = natural_workload()
    image = torch.from_numpy(images_np[0]).to(dev)
    del images_np
    tokens = np.zeros(T, np.int32)
    tokens[:4] = toks[0, :4]
    tokens[4] = EOS
    reps = {}
    for method in GRAD_METHODS:
        ex = explainer_for(cap, params, dev, method=method)
        ex.analyze(image, tokens)   # first call: captures, cuDNN's first calls
        kernels.reset_launches()
        e, ms = timed(ex.analyze, image, tokens)
        want = explain_launches("adaptiveattention", None, [(1, bucket_for(4))], method=method)
        # a Guided-GradCAM map is zero where the word's CAM is all negative
        check_explanations([e], [4], f"phase 8d {method}", failures,
                           nonzero=method != "guided_gradcam")
        launches = counts()
        reps[method] = dict(ms=ms, launches=launches, expected=want,
                            cpu=grad_vs_cpu(ex, cap, params, image, tokens, e, failures))
        log(f"  {method}: {ms:.2f} ms for 4 words at {IMAGE}x{IMAGE} (IG {ex._ig_steps} steps, "
            f"SmoothGrad {ex._sg_samples} samples); launches {launches}")
        if reps[method]["launches"] != want:
            failures.append(f"phase 8d {method}: launches {reps[method]['launches']}, {want}")
        del ex
    return reps


# ---------------------------------------------------------------------------
# phase 9: the entry points at full width (Trainer, grid-TD training, the
# inference API, LRPFinetuner) on a generated dataset
# ---------------------------------------------------------------------------
N_TRAIN_IMAGES = 421        # x 5 captions of 10 words: every word of the list 3 times
CAPTION_WORDS = 10
# phase 9b: the trainer's final params on the card may lie at most this
# multiple of the CPU-f32 run's distance from a CPU-f64 run (by the 2-norm
# over all params, over the f64 params' norm), or this share of the two
# steps' update (its norm over the same). A ReLU or max-pool near-tie that
# an f32 forward flips against f64 moves every lower VGG leaf's gradient by
# 1e-4 to 1.5e-3 of its norm, on the CPU as on the card
# (scripts/train_grad_accuracy.py); Adam's first steps, lr g / (|g| + eps),
# then turn the sign of each small-|g| element that moved: the run that
# flipped lies ~1e-4 of the params' norm from f64, ~0.5 % of the update,
# the one that did not ~1e-7. A lost, repeated or misplaced step moves
# every element by ~lr: 50-100 % of the update
TRAINER_F64_RATIO, TRAINER_UPDATE_FLOOR = 2.0, 0.05


_SEEDED = {}


def seeded_images(paths, random_transform=False):
    """Stands in for ``ImagePreprocessor.preprocess_batch_paths``: a seeded
    (224, 224, 3) array per path, at the scale of VGG-preprocessed pixels,
    made once and kept (as a decoder that releases the GIL would cost the
    training thread little; drawing them anew in the prefetch thread every
    epoch held the eager train step back)."""
    import zlib

    import numpy as np

    for p in paths:
        if p not in _SEEDED:
            _SEEDED[p] = np.random.default_rng(zlib.crc32(p.encode())).standard_normal(
                (IMAGE, IMAGE, 3), dtype=np.float32) * 50
    return np.stack([_SEEDED[p] for p in paths])


def smoke_dataset(cfg):
    """A caption dataset whose training vocabulary under words_min_occur = 3
    is bench's 7003 (7001 words, and SOS and EOS): N_TRAIN_IMAGES images of
    five 10-word captions over the word list, each word three times or more;
    N_VAL and N_TEST images of five captions each for validation and test."""
    import numpy as np

    from lrp_imagecaptioning_torch.data.datasets import Dataset, Datum

    rng = np.random.default_rng(0)
    words = np.array([f"w{i:04d}" for i in range(VOCAB - 2)])
    slots = N_TRAIN_IMAGES * 5 * CAPTION_WORDS
    seq = np.concatenate([np.repeat(np.arange(len(words)), 3),
                          rng.integers(0, len(words), slots - 3 * len(words))])
    caps = [" ".join(words[row]) for row in rng.permutation(seq).reshape(-1, CAPTION_WORDS)]

    def split(name, n, captions):
        out = []
        for i in range(n):
            fn = f"{name}_{i:04d}.jpg"
            five = tuple(captions[5 * i:5 * i + 5])
            out += [Datum(fn, fn, c, five) for c in (five if name == "train" else five[:1])]
        return out

    ds = Dataset(cfg)
    ds.training_set = split("train", N_TRAIN_IMAGES, caps)
    for name, n in (("val", N_VAL), ("test", N_TEST)):
        other = [" ".join(rng.choice(words, CAPTION_WORDS)) for _ in range(5 * n)]
        setattr(ds, "validation_set" if name == "val" else "test_set", split(name, n, other))
    return ds


def timed_method(obj, name, store, keep=None):
    """Wrap ``obj.name`` so each call's host time after a synchronize (ms) is
    appended to ``store[name]`` and, with ``keep``, ``keep(result)`` to
    ``store[name + ":out"]``. Returns the unwrapped attribute."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        store.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        if keep is not None:
            store.setdefault(name + ":out", []).append(keep(out))
        return out

    setattr(obj, name, wrapper)
    return fn


def smoke_trainer(cfg, ds, label, device="cuda", parts=None, steps_per_call=1):
    """A Trainer on ``ds`` with seeded images; with ``parts`` its epoch's
    pieces are timed into it."""
    from lrp_imagecaptioning_torch.train.trainer import Trainer

    t = Trainer("adaptiveattention", cfg, ds, label=label, seed=0, device=device,
                steps_per_call=steps_per_call)
    t.provider.image_preprocessor.preprocess_batch_paths = seeded_images
    if parts is not None:
        for name in ("_epoch", "_save", "_train_step"):
            timed_method(t, name, parts)
        for name in ("predict_test_set", "_evaluate"):
            timed_method(t.inference, name, parts)
    return t


def epoch_split(parts, e, steps):
    """Epoch ``e``'s pieces (ms) from the timed calls: each epoch runs
    _epoch twice (train, validation), the test split's decode and its
    metrics, and one checkpoint; the train part splits into the step calls
    and the rest (waiting on the prefetch queue, the copies to the card)."""
    in_steps = sum(parts["_train_step"][e * steps:(e + 1) * steps])
    return dict(train=parts["_epoch"][2 * e], ms_per_train_step=parts["_epoch"][2 * e] / steps,
                step_calls=in_steps / steps, batches_and_copies=parts["_epoch"][2 * e] - in_steps,
                validation=parts["_epoch"][2 * e + 1], greedy_decode=parts["predict_test_set"][e],
                metrics=parts["_evaluate"][e], checkpoint=parts["_save"][e])


def phase_trainer(dev, failures, report):
    """9a: Trainer.run(epochs=2, steps_per_epoch=TRAINER_STEPS), then a new
    Trainer that resumes the latest checkpoint and runs one more epoch (the
    counted pass of the "trainer" path)."""
    import csv

    import numpy as np

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.train.checkpoint import latest_checkpoint

    log("  the images are seeded arrays handed to the provider in place of decoded files "
        "(seeded_images): no dataset ships with the repo, and the card's host need not have "
        "PIL to decode one")
    cfg = FlickrConfig()
    ds = smoke_dataset(cfg)
    parts = {}
    t = smoke_trainer(cfg, ds, "phase9", dev, parts)
    vocab = t.provider.vocab_size
    if vocab != VOCAB:
        failures.append(f"9a: the dataset's vocabulary is {vocab}, not {VOCAB}")
    per_epoch = {"lrp_linear": 0, "conv3x3_fused": 0, "lrp_a1b0_fused": 0,
                 "lstm_gates": TRAINER_STEPS * T_TRAIN + N_VAL // B_TRAIN * T_TRAIN
                 + N_TEST // B_TRAIN * T}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    hist, run_ms = timed(t.run, 2, None, TRAINER_STEPS)
    two = counts()
    if two != {k: 2 * v for k, v in per_epoch.items()}:
        failures.append(f"9a: two epochs launched {two}, {per_epoch} an epoch expected")

    # the host-to-device copy of one batch's int32 one-hot targets
    (_, _), y = next(t.provider.training_set(pad_to_length=T_TRAIN))
    copy_ms = min(timed(lambda: torch.as_tensor(y, device=dev))[1] for _ in range(5))

    t2 = smoke_trainer(cfg, ds, "phase9", dev, parts)
    if not t2.resume_latest() or t2._initial_epoch != 2:
        failures.append(f"9a: resume_latest did not continue at epoch 2 ({t2._initial_epoch})")
    kernels.reset_launches()
    hist3, resumed_ms = timed(t2.run, 3, None, TRAINER_STEPS)
    launches = counts()
    mem = memory_gib()
    hist += hist3
    splits = [epoch_split(parts, e, TRAINER_STEPS) for e in range(3)]
    with open(os.path.join(t2.result_dir, "metrics-log.csv"), newline="") as f:
        csv_epochs = [row["epoch"] for row in csv.DictReader(f)]
    latest = os.path.basename(latest_checkpoint(t2.result_dir) or "")
    losses = [h[k] for h in hist for k in ("loss", "val_loss")]
    bare = report.get("train", {}).get("ms_per_step")
    out = dict(vocab=vocab, epochs=len(hist), run_ms=run_ms, resumed_ms=resumed_ms, split_ms=splits,
               target_copy=dict(bytes=y.nbytes, ms=copy_ms, gb_s=y.nbytes / copy_ms / 1e6),
               launches=launches, expected=per_epoch, two_epoch_launches=two, csv_epochs=csv_epochs,
               latest_checkpoint=latest, bare_train_step_ms=bare,
               history=[{k: v for k, v in h.items() if isinstance(v, (int, float))} for h in hist],
               **mem)
    for e, sp in enumerate(splits):
        log(f"  epoch {e}: " + ", ".join(f"{k} {v:.1f}" for k, v in sp.items()) + " ms; "
            f"loss {hist[e]['loss']:.4f} val_loss {hist[e]['val_loss']:.4f} "
            f"val_cider {hist[e]['val_cider']:.4f} lr {hist[e]['learning_rate']:.3g}")
    log(f"  a train step in the epoch {splits[-1]['ms_per_train_step']:.1f} ms (phase 6's bare "
        f"step {bare if bare is None else f'{bare:.1f}'} ms); targets {y.shape} int32 = "
        f"{y.nbytes / 1e6:.1f} MB to the card in {copy_ms:.2f} ms "
        f"({out['target_copy']['gb_s']:.1f} GB/s, pageable); peak memory "
        f"{mem['peak_gib']:.2f} GiB allocated, {mem['reserved_gib']:.2f} reserved")
    log(f"  the resumed epoch launched {launches}; CSV epochs {csv_epochs}; latest {latest}")
    out["steps_per_call"] = trainer_k_steps(dev, failures, cfg, ds, t2, per_epoch)
    if csv_epochs != ["0", "1", "2"]:
        failures.append(f"9a: the CSV's epochs are {csv_epochs}")
    if not latest.startswith("ckpt_02_"):
        failures.append(f"9a: the latest checkpoint is {latest!r}, not epoch 2's")
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"9a: a loss is not finite: {losses}")
    return launches, out, (cfg, ds, t2)


def trainer_k_steps(dev, failures, cfg, ds, resumed, per_epoch):
    """9a at ``steps_per_call`` K_TRAIN: a Trainer on the resumed trainer's
    latest checkpoint runs one epoch of TRAINER_STEPS steps (K-step calls,
    each step replayed from one captured graph; the first epoch captures),
    then the same epoch again, counted: its launches are one epoch's
    (``per_epoch``), its step calls timed against the K = 1 epochs'."""
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.train.checkpoint import latest_checkpoint

    parts = {}
    t = smoke_trainer(cfg, ds, "phase9_k", dev, parts, steps_per_call=K_TRAIN)
    multi = timed_method(t, "_multi_step", parts)
    t.load_weights(latest_checkpoint(resumed.result_dir))
    first, first_ms = timed(t.run, 1, None, TRAINER_STEPS)
    kernels.reset_launches()
    hist, run_ms = timed(t.run, 1, None, TRAINER_STEPS)
    launches = counts()
    calls = parts["_multi_step"][-TRAINER_STEPS // K_TRAIN:]
    out = dict(K=K_TRAIN, first_run_ms=first_ms, run_ms=run_ms, captures=multi.graph.captures,
               train_ms=parts["_epoch"][2], ms_per_train_step=parts["_epoch"][2] / TRAINER_STEPS,
               call_ms=calls, step_in_calls_ms=sum(calls) / TRAINER_STEPS, launches=launches,
               count=t.opt_state["count"], loss=[first[0]["loss"], hist[0]["loss"]])
    log(f"  9a at steps_per_call {K_TRAIN}: an epoch's train part {out['train_ms']:.1f} ms = "
        f"{out['ms_per_train_step']:.1f} ms a step, {out['step_in_calls_ms']:.1f} of it in the "
        f"{len(calls)} calls ({[round(c, 1) for c in calls]} ms); first run {first_ms:.0f} ms "
        f"(it captures), the counted one {run_ms:.0f}; loss {out['loss']}; captures "
        f"{out['captures']}; Adam count {out['count']}; launches {launches}")
    if launches != per_epoch:
        failures.append(f"9a at steps_per_call {K_TRAIN}: launches {launches}, {per_epoch} an "
                        "epoch expected")
    if out["captures"] != 1 or out["count"] != resumed.opt_state["count"] + 2 * TRAINER_STEPS:
        failures.append(f"9a at steps_per_call {K_TRAIN}: captures {out['captures']}, count "
                        f"{out['count']}")
    if not all(math.isfinite(v) for v in out["loss"]):
        failures.append(f"9a at steps_per_call {K_TRAIN}: a loss is not finite: {out['loss']}")
    return out


def first_difference(a, b):
    """(position, word of a, word of b) of the first word two captions
    differ at; None past a caption's end."""
    wa, wb = a.split(), b.split()
    i = next((i for i, (x, y) in enumerate(zip(wa, wb)) if x != y), min(len(wa), len(wb)))
    return i, (wa[i:] or [None])[0], (wb[i:] or [None])[0]


def first_step_grads(t):
    """The loss gradient at the trainer's params on its first training batch
    (the batch its run starts with), as CPU f64 leaves."""
    from lrp_imagecaptioning_torch.train.step import value_and_grad
    from lrp_imagecaptioning_torch.weights import tree_leaves

    (cap_in, imgs), y = next(t.provider.training_set(pad_to_length=t.config.sentence_length + 1))
    imgs, cap_in, y = t._place(imgs), t._place(cap_in), t._place(y)
    loss_fn = t.captioner.loss_fn()
    _, _, g = value_and_grad(lambda p: (loss_fn(
        t.captioner.forward_train(p, imgs, cap_in, None), y), None), t.params)
    return [x.cpu().double() for x in tree_leaves(g)]


def phase_trainer_cpu(dev, failures, cfg, ds):
    """9b: one epoch of two steps at batch 2 without dropout, on the card and
    on the CPU in f32 and in f64 from the same params (validation and test
    splits cut to 2 images); the greedy test captions on the card must equal
    the CPU-f32 run's. The first step's gradient, leaf by leaf, is held as
    phase 7 holds the fine-tune's (the 2-norm within FT_GRAD_RATIO times the
    CPU-f32 run's distance from f64, or TOL_FT_GRAD_L2_FLOOR), and the final
    params by the 2-norm over all of them within TRAINER_F64_RATIO times the
    CPU-f32 run's distance, or TRAINER_UPDATE_FLOOR of the update's norm."""
    from lrp_imagecaptioning_torch.data.datasets import Dataset
    from lrp_imagecaptioning_torch.weights import tree_leaves, tree_to

    cfg_b = cfg.replace(batch_size=2, drop_rate=0.0)
    ds_b = Dataset(cfg_b)
    ds_b.training_set = ds.training_set
    ds_b.validation_set, ds_b.test_set = ds.validation_set[:2], ds.test_set[:2]
    runs, params0 = {}, None
    t0 = time.perf_counter()
    for name, device, dtype in (("card", dev, None), ("f32", "cpu", None),
                                ("f64", "cpu", torch.float64)):
        t = smoke_trainer(cfg_b, ds_b, f"phase9b-{name}", device)
        if params0 is None:
            params0 = tree_to(t.params, "cpu")
        else:
            t.params = tree_to(params0, dtype=dtype)
            t.opt_state = t.optimizer.init(t.params)
        grads = first_step_grads(t)
        hist = t.run(epochs=1, steps_per_epoch=2)
        runs[name] = (hist[0], [x.cpu().double() for x in tree_leaves(t.params)],
                      [c for c, _ in t.inference.predict_test_set()], grads)
        if name == "card":
            t0 = time.perf_counter()
    cpu_s = time.perf_counter() - t0
    names, ref, g64 = leaf_names(params0), runs["f64"][1], runs["f64"][3]
    norm = lambda leaves: float(sum((x ** 2).sum() for x in leaves).sqrt())  # noqa: E731
    ref_norm = norm(ref)
    update = norm([b - a.double() for a, b in zip(tree_leaves(params0), ref)]) / ref_norm
    out = dict(cpu_s=cpu_s, update_norm=update)
    l2 = {}
    for name in ("card", "f32"):
        out[f"params_{name}_vs_f64"] = norm([a - b for a, b in zip(runs[name][1], ref)]) / ref_norm
        l2[name] = [((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                    for a, b in zip(runs[name][3], g64)]
        out[f"grads_{name}_vs_f64_l2_worst"] = max(zip(l2[name], names))
    bound = max(TRAINER_F64_RATIO * out["params_f32_vs_f64"], TRAINER_UPDATE_FLOOR * update)
    out["params_bound"] = bound
    out["grad_leaves_over"] = [(n, a, b) for n, a, b in zip(names, l2["card"], l2["f32"])
                               if a > max(FT_GRAD_RATIO * b, TOL_FT_GRAD_L2_FLOOR)]
    caps = {name: r[2] for name, r in runs.items()}
    out.update(captions=caps, loss={k: r[0]["loss"] for k, r in runs.items()},
               val_loss={k: r[0]["val_loss"] for k, r in runs.items()})
    log(f"  {out}")
    if out["params_card_vs_f64"] > bound:
        failures.append(f"9b: the card's params lie {out['params_card_vs_f64']:.3e} from f64, CPU "
                        f"f32 {out['params_f32_vs_f64']:.3e}, the update {update:.3e} (bound "
                        f"{bound:.3e})")
    if out["grad_leaves_over"]:
        failures.append(f"9b: first-step gradients over {FT_GRAD_RATIO}x CPU f32 and "
                        f"{TOL_FT_GRAD_L2_FLOOR}: {out['grad_leaves_over']}")
    for i, (a, b) in enumerate(zip(caps["card"], caps["f32"])):
        if a != b:
            pos, wa, wb = first_difference(a, b)
            failures.append(f"9b: test caption {i} differs at word {pos}: card {wa!r}, CPU f32 "
                            f"{wb!r} (f64: {caps['f64'][i]!r})")
    return out


def phase_gridtd_train(dev, failures, mask_seed=9):
    """9c: three grid-TD train steps at batch 32 (dropout 0.5, Adam beta1
    0.8) in each loss mode, then one step's loss and gradients at batch 1
    on the card, on the CPU in f32 and in f64, without dropout and with one
    set of masks drawn on the CPU: phase 7's gates."""
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models import gridtd
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.train.optimizer import make_optimizer
    from lrp_imagecaptioning_torch.train.step import make_train_step, value_and_grad
    from lrp_imagecaptioning_torch.weights import tree_leaves, tree_to

    want = {"lrp_linear": 0, "lstm_gates": 2 * T_TRAIN, "conv3x3_fused": 0, "lrp_a1b0_fused": 0}
    out, launches = {}, None
    for loss_mode in ("from_logits", "keras_categorical"):
        cfg = FlickrConfig(loss_mode=loss_mode)
        cap = build_captioner("gridTD", cfg, VOCAB)
        params = cap.init_params(seed=0, device=dev)
        opt = make_optimizer("gridTD", cfg.learning_rate)
        batch = train_batch(torch.Generator(device=dev).manual_seed(2), dev, cfg.batch_size)
        torch.cuda.reset_peak_memory_stats()
        _, _, records = counted_steps(make_train_step(cap, opt), 3, params, opt.init(params),
                                      batch, torch.Generator(device=dev).manual_seed(3), want,
                                      failures, f"gridtd_train {loss_mode}")
        launches = records[-1]["launches"]
        steady = sum(r["ms"] for r in records[1:]) / (len(records) - 1)
        out[loss_mode] = dict(ms_per_step=steady, beta1=opt.b1, steps=records, **memory_gib())
        log(f"  {loss_mode}: {steady:.1f} ms a step after the first; Adam beta1 {opt.b1}; peak "
            f"{out[loss_mode]['peak_gib']:.2f} GiB allocated")
        del params, batch

    cfg = FlickrConfig(drop_rate=0.0)
    cap = build_captioner("gridTD", cfg, VOCAB)
    params = cap.init_params(seed=0, device=dev)
    batch = train_batch(torch.Generator(device=dev).manual_seed(8), dev, 1)
    params_c = tree_to(params, "cpu")
    masks = gridtd.draw_dropout_masks(torch.Generator().manual_seed(mask_seed),
                                      params_c["decoder"], 1, cfg, 0.5)

    def run(p, images, captions_in, y, m):
        res = []
        for mk in (None, m):
            loss, _, grads = value_and_grad(
                lambda q: (cap.loss(q, images, captions_in, y, None, masks=mk), None), p)
            res += [float(loss), [g.cpu().double() for g in tree_leaves(grads)]]
        return res

    t0 = time.perf_counter()
    cpu = [x.cpu() for x in batch]
    runs = {"card": run(params, *batch, masks.to(dev)), "f32": run(params_c, *cpu, masks),
            "f64": run(tree_to(params_c, dtype=torch.float64), cpu[0].double(), cpu[1],
                       cpu[2].double(), masks.to(torch.float64))}
    names = leaf_names(params_c)
    cmp = dict(cpu_s=time.perf_counter() - t0)
    for sfx, idx in (("", 1), ("_dropout", 3)):
        ref = runs["f64"][idx]
        for name in ("card", "f32"):
            cmp[f"loss_{name}_vs_f64{sfx}"] = abs(runs[name][idx - 1] - runs["f64"][idx - 1]) \
                / abs(runs["f64"][idx - 1])
            cmp[f"grads_{name}{sfx}"], cmp[f"worst_leaf_{name}{sfx}"] = max(
                (rel_err(a, b)[1], n) for n, a, b in zip(names, runs[name][idx], ref))
            cmp[f"l2_{name}{sfx}"] = [((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                                      for a, b in zip(runs[name][idx], ref)]
    cmp["grad_ratio"] = cmp["grads_card"] / max(cmp["grads_f32"], 1e-6)
    cmp["leaves_over_dropout"] = [
        (n, a, b) for n, a, b in zip(names, cmp["l2_card_dropout"], cmp["l2_f32_dropout"])
        if a > max(FT_GRAD_RATIO * b, TOL_FT_GRAD_L2_FLOOR)]
    log("  batch 1 vs CPU: " + str({k: v for k, v in cmp.items() if not k.startswith("l2_")}))
    if cmp["grad_ratio"] > FT_GRAD_RATIO:
        failures.append(f"9c: grid-TD gradients: card {cmp['grads_card']:.3e} from f64, CPU f32 "
                        f"{cmp['grads_f32']:.3e} (limit {FT_GRAD_RATIO}x)")
    if cmp["leaves_over_dropout"]:
        failures.append(f"9c: grid-TD gradients with dropout over {FT_GRAD_RATIO}x CPU f32 and "
                        f"{TOL_FT_GRAD_L2_FLOOR}: {cmp['leaves_over_dropout']}")
    out["cpu"] = cmp
    return launches, out


def phase_evaluate_finetune(dev, failures, report, cfg, trainer):
    """9d: BeamSearchInference(beam_size=3).evaluate_test_set() on 9a's last
    checkpoint (the counted pass of the "evaluate" path), and two steps of
    LRPFinetuner.run through the provider at batch 32, mode 'mean'. Returns
    the launches, the report, and the checkpoint's params for phase 10."""
    from lrp_imagecaptioning_torch.evalx import metrics, ptb
    from lrp_imagecaptioning_torch.infer.api import BeamSearchInference
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.train.checkpoint import latest_checkpoint, restore_checkpoint
    from lrp_imagecaptioning_torch.train.lrp_finetune import LRPFinetuner

    ckpt = latest_checkpoint(trainer.result_dir)
    params, _ = restore_checkpoint(ckpt, device=dev)
    inf = BeamSearchInference(trainer.captioner, params, trainer.provider, beam_size=BEAM,
                              max_caption_length=cfg.sentence_length, device=dev)
    inf.predict_batch(seeded_images([f"warm_{i}" for i in range(B_TRAIN)]))
    parts = {}
    for name in ("predict_test_set", "_evaluate"):
        timed_method(inf, name, parts)
    kernels.reset_launches()
    m, ms = timed(inf.evaluate_test_set)
    launches = counts()
    paths = dict(tokenizer="corenlp jar" if ptb._find_corenlp_jar() else (
                     "nltk Treebank" if importlib_has("nltk") else "_lite_tokenize"),
                 meteor="jar" if metrics.METEOR()._jar else (
                     "fallback, Porter stems" if importlib_has("nltk") else "fallback, no stems"),
                 spice="jar" if metrics.SPICE()._jar else "fallback")
    ev = dict(checkpoint=os.path.basename(ckpt), ms=ms, img_per_s=N_TEST / ms * 1e3,
              decode_ms=parts["predict_test_set"][0], metrics_ms=parts["_evaluate"][0],
              metrics=m, launches=launches, paths=paths)
    log(f"  beam {BEAM} over the {N_TEST} test images: {ms:.1f} ms = {ev['img_per_s']:.2f} img/s "
        f"(decode {ev['decode_ms']:.1f}, metrics {ev['metrics_ms']:.1f} ms); launches {launches}")
    log(f"  metrics {m}; paths {paths}")
    if not all(math.isfinite(v) for v in m.values() if isinstance(v, float)):
        failures.append(f"9d: a metric is not finite: {m}")

    tuner = LRPFinetuner(trainer.captioner, params, trainer.provider, mode="mean",
                         learning_rate=1e-6, device=dev)
    parts = {}
    timed_method(tuner, "_step", parts)
    kernels.reset_launches()
    ft, ft_ms = timed(tuner.run, 0, 2, os.path.join(os.getcwd(), "lrp-finetune"))
    ft_launches = counts()
    want = {k: 2 * v for k, v in expected_launches("finetune", cfg).items()}
    bare = report.get("finetune", {}).get("ms_per_step")
    out = dict(evaluate=ev, finetune=dict(metrics=ft, ms=ft_ms, step_ms=parts["_step"],
                                          launches=ft_launches, expected=want,
                                          bare_step_ms=bare))
    log(f"  LRPFinetuner.run(save_idx=0, epoch_length=2): steps {parts['_step'][0]:.1f}, "
        f"{parts['_step'][1]:.1f} ms (phase 6b's random batch: "
        f"{bare if bare is None else f'{bare:.1f}'} ms); {ft}; launches {ft_launches}")
    if ft_launches != want:
        failures.append(f"9d: the fine-tune launched {ft_launches}, {want} expected")
    return launches, out, restore_checkpoint(ckpt, device=dev)[0]


def importlib_has(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def phase_entry_points(dev, failures, report):
    """Phase 9 in a scratch directory of the checkout (``build/phase9``, not
    kept: each checkpoint at full width is ~0.28 GB), which it removes.
    Returns the launches, the report and, for phase 10, 9a's config and
    dataset with 9d's checkpoint params (None where 9a or 9d did not run)."""
    import shutil

    work = os.path.join(HERE, "build", "phase9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    launches, out, handoff = {}, {}, None
    try:
        steps = [("9a: Trainer.run, adaptive attention, two epochs, resume, one more", "trainer"),
                 ("9b: the trainer on the card against the CPU, batch 2", "trainer_cpu"),
                 ("9c: grid-TD training", "gridtd_train"),
                 ("9d: evaluate and finetune-lrp through the provider", "evaluate")]
        ctx = None
        for title, key in steps:
            log(f" phase {title}")
            t0 = time.perf_counter()
            try:
                if key == "trainer":
                    launches["trainer"], out[key], ctx = phase_trainer(dev, failures, report)
                elif key == "gridtd_train":
                    launches["gridtd_train"], out[key] = phase_gridtd_train(dev, failures)
                elif ctx is None:
                    failures.append(f"phase {title} skipped: 9a did not run")
                elif key == "trainer_cpu":
                    out[key] = phase_trainer_cpu(dev, failures, ctx[0], ctx[1])
                else:
                    launches["evaluate"], out[key], params = phase_evaluate_finetune(
                        dev, failures, report, ctx[0], ctx[2])
                    handoff = dict(cfg=ctx[0], ds=ctx[1], params=params)
            except Exception:  # noqa: BLE001 — a sub-phase that raises is recorded as failed
                traceback.print_exc()
                failures.append(f"phase {title} raised")
            log(f"  ({time.perf_counter() - t0:.1f} s)")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return launches, out, handoff


# ---------------------------------------------------------------------------
# phase 10: the explanation entry points (the Explainer's deep_taylor and
# deep_lift, evaluate-bbox, analyze-words, the drivers, the CLI, word vectors)
# on phase 9's checkpoint and dataset
# ---------------------------------------------------------------------------
# 10b: the bbox scores of one image from the card's Explanation and from a
# CPU-f32 Explainer's. Their heatmaps lie within TOL_CPU_MAPS of each other
# (phase 4); a score is a ratio of sums over the thresholded map, which a
# value within that distance of a threshold moves by its own mass only
TOL_BBOX_SCORE = 1e-3
N_BBOX_WORDS = 2            # category words an image: two of its caption's first BBOX_SPAN
BBOX_SPAN = 4               # (the CPU-f32 run explains that many words at most)
TOP_WORDS = 10              # 10c: the commonest predicted words as the categories


def write_test_jpegs(ds):
    """Phase 9's test images as JPEGs in the working directory, at the paths
    its test datums name: each the seeded array of ``seeded_images`` shifted
    into 0..255, so that the provider and the drivers decode real files."""
    import numpy as np
    from PIL import Image

    for d in ds.test_set:
        if not os.path.exists(d.img_path):
            arr = np.clip(seeded_images([d.img_path])[0] + 128, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(d.img_path, quality=90)


def provider_test_images(provider):
    """The test split through the provider (JPEG decode, VGG preprocessing):
    (images (N, 224, 224, 3), their file names)."""
    import numpy as np

    gen = provider.test_set(include_datum=True)
    imgs, names = [], []
    for _ in range(provider.test_steps):
        (_, x), _, data = next(gen)
        imgs.append(x)
        names += [d.img_filename for d in data]
    return np.concatenate(imgs), names


def analyze_many_plan(calls, batch):
    """The dispatches of recorded ``analyze_many`` calls (each one decode and
    the sorted chunks of its captions' word counts at ``batch``)."""
    return [c for words in calls for c in sorted_plan(words, batch)]


def plan_summary(dev, path, plan, failures, detail):
    """``path``'s kernels timed at the shapes of ``plan`` [(images, bucket)],
    one row set per chunk, summed over the chunks; a chunk at phase 2's f32
    shapes (B_MAIN images, T words) takes phase 2's rows."""
    import copy

    gen = torch.Generator(device=dev).manual_seed(10)
    out, cache = {}, {}
    for name, (_, _, check) in KERNEL_META.items():
        if name not in PATH_KERNELS[path]:
            continue
        rows = []
        for images, bucket in plan:
            key = (name, images, bucket)
            if key not in cache:
                f32_rows = [r for r in detail.get(name, ()) if r["path"] == "f32"]
                if (images, bucket) == (B_MAIN, T) and f32_rows and path in (
                        "deep_taylor", "bbox", "serve_f32", "exported", "exported_grad"):
                    cache[key] = f32_rows
                else:
                    cache[key] = check(gen, dev, path, (None, images, bucket))
            rows += copy.deepcopy(cache[key])
        log(f"  {path}: {name} at the run's chunks {plan}")
        out[name] = summarize_rows(name, path, B_TRAIN if path == "bbox" else plan[0][0], rows,
                                   failures)
        detail.setdefault(name, []).extend(rows)
    return out


def phase_deep_methods(dev, failures, cap, params, pp, images):
    """10a: deep_taylor and deep_lift, f32, one counted analyze_batch of
    B_MAIN images each (launches as derived: deep_taylor as f32 lrp,
    deep_lift without K3), then the first image with a word against CPU f32
    and f64 (``walk_vs_cpu``: deep_taylor on CPU_WORDS words, deep_lift on
    the first)."""
    out, launches = {}, None
    images = torch.from_numpy(images[:B_MAIN]).to(dev)
    for method in ("deep_taylor", "deep_lift"):
        ex, res, rep = explain_batch_run(cap, params, dev, images, None, f"10a {method}",
                                         failures, method=method, pp=pp)
        if method == "deep_taylor":
            launches = rep["launches"]
        i = next((i for i, e in enumerate(res) if e.words), None)
        if i is None:
            failures.append(f"10a {method}: every caption is empty")
        else:
            taylor = method == "deep_taylor"
            rep["cpu"] = walk_vs_cpu(ex, cap, params, images[i], res[i].tokens_1based, failures,
                                     f"10a {method}", CPU_WORDS if taylor else 1, taylor)
        out[method] = rep
        del ex, res
        gc.collect()
        torch.cuda.empty_cache()
    return launches, out


def bbox_entities(names, toks, pp):
    """An entities dict for the images: N_BBOX_WORDS words of each image's own
    beam caption (from its first BBOX_SPAN, past the articles) as categories,
    each with one or two seeded boxes on the 224x224 image."""
    import numpy as np

    from lrp_imagecaptioning_torch.evalx.bbox import FILTER
    from lrp_imagecaptioning_torch.explain.engine import _n_explained

    rng = np.random.default_rng(10)
    out = {}
    for name, row in zip(names, toks):
        n = _n_explained(row, EOS)
        words = [pp.word_of[int(t)] for t in row[:min(n, BBOX_SPAN)]]
        pool = sorted({w for w in words if w not in FILTER})
        picked = rng.permutation(pool)[:N_BBOX_WORDS] if pool else []
        cats = {str(w): str(k) for k, w in enumerate(picked)}
        boxes = {}
        for cid in cats.values():
            boxes[cid] = []
            for _ in range(rng.integers(1, 3)):
                x0, y0 = (int(v) for v in rng.integers(0, 160, size=2))
                w, h = (int(v) for v in rng.integers(32, 224 - max(x0, y0), size=2))
                boxes[cid].append([x0, y0, min(x0 + w, 224), min(y0 + h, 224)])
        out[name] = {"categories": cats, "bbox": boxes, "shape": (IMAGE, IMAGE),
                     "resize_ratio": (1.0, 1.0)}
    return out


def phase_bbox(dev, failures, cap, params, provider, images, names, detail):
    """10b: evaluate_dataset then analyze_results over the test split at the
    provider's batch (B_TRAIN), f32 lrp, with an entities dict that puts two
    words of each image's caption in its boxes; img/s, the time in
    analyze_many on the card and in the scoring on the host, launches held to
    analyze_many's plan. Then one image's scores from the card against a
    CPU-f32 Explainer's, both explaining the first BBOX_SPAN words."""
    import numpy as np

    from lrp_imagecaptioning_torch.evalx import bbox
    from lrp_imagecaptioning_torch.explain.engine import Explainer, _n_explained
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.weights import tree_to

    pp = provider.caption_preprocessor
    ex = Explainer(cap, params, pp, beam_size=BEAM, word_buckets=BUCKETS, batch_size=B_TRAIN,
                   device=dev)
    toks = ex._decode(ex._as_images(images))
    entities = bbox_entities(names, toks, pp)
    ex.warmup(images[:B_TRAIN])
    parts = {}
    timed_method(ex, "analyze_many", parts, keep=lambda out: [len(e.words) for e in out])
    evaluate = timed_method(bbox.EvaluationBbox, "evaluate", parts)
    kernels.reset_launches()
    try:
        results, ms = timed(lambda: bbox.evaluate_dataset(ex, provider, entities,
                                                          "bbox-correctness.json"))
    finally:
        bbox.EvaluationBbox.evaluate = evaluate
        del ex.analyze_many
    launches = counts()
    agg = bbox.analyze_results(results, out_csv="bbox-correctness.csv")
    calls = parts["analyze_many:out"]
    plan = analyze_many_plan(calls, B_TRAIN)
    want = explain_launches("adaptiveattention", None, plan, decodes=len(calls))
    scored = sum(len(r["lrp"]) for r in results.values())
    rep = dict(images=len(results), ms=ms, img_per_s=len(results) / ms * 1e3,
               analyze_many_ms=sum(parts["analyze_many"]), scoring_ms=sum(parts["evaluate"]),
               plan=plan, launches=launches, expected=want, categories_scored=scored,
               aggregate={k: v["0.0"] for k, v in agg.items()})
    rep["rest_ms"] = ms - rep["analyze_many_ms"] - rep["scoring_ms"]
    log(f"  evaluate_dataset over {len(results)} images: {ms:.1f} ms = {rep['img_per_s']:.2f} "
        f"img/s (analyze_many on the card {rep['analyze_many_ms']:.1f} ms, scoring on the host "
        f"{rep['scoring_ms']:.1f}, the rest {rep['rest_ms']:.1f}: provider, json); plan {plan}; "
        f"{scored} categories scored; launches {launches}; at threshold 0 {rep['aggregate']}")
    if launches != want:
        failures.append(f"10b: launches {launches}, {want} derived from the plan")
    if len(results) != len(names) or not scored:
        failures.append(f"10b: {len(results)} images, {scored} categories scored")
    if not all(os.path.exists(f) for f in ("bbox-correctness.json", "bbox-correctness.csv")):
        failures.append("10b: the json or csv was not written")
    summary = plan_summary(dev, "bbox", plan, failures, detail)

    # one image on the card and on the CPU (f32), the same words explained
    i = next((i for i, n in enumerate(names) if entities[n]["categories"]), None)
    if i is None:
        failures.append("10b: no caption has a category word")
        return ex, launches, summary, rep
    n = min(_n_explained(toks[i], EOS), BBOX_SPAN)
    cut = np.zeros(T, np.int32)
    cut[:n] = toks[i][:n]
    cut[n] = EOS
    t0 = time.perf_counter()
    cpu = Explainer(cap, tree_to(params, "cpu"), pp, beam_size=BEAM, word_buckets=(n,),
                    device="cpu")
    cpu_tokens = cpu.predict_caption(images[i])[0]
    ev = bbox.EvaluationBbox(entities, ex)
    card_s = ev.evaluate(None, names[i], explanation=ex.analyze(images[i], cut))
    cpu_s = ev.evaluate(None, names[i], explanation=cpu.analyze(images[i], cut))
    worst = max((abs(a[c][t] - b[c][t]) for a, b in zip(card_s[:2], cpu_s[:2]) for c in b
                 for t in b[c]), default=0.0)
    rep["cpu"] = dict(image=names[i], words=n, cpu_s=time.perf_counter() - t0,
                      tokens_equal=bool(np.array_equal(cpu_tokens, toks[i])),
                      categories=card_s[2], worst_score_diff=worst)
    log(f"  one image on the card and on the CPU (f32), {n} words: {rep['cpu']}")
    if not rep["cpu"]["tokens_equal"] or card_s[2] != cpu_s[2]:
        failures.append(f"10b: card and CPU captions or categories differ: {rep['cpu']}")
    elif worst > TOL_BBOX_SCORE:
        failures.append(f"10b: a card score lies {worst:.3e} from the CPU's")
    return ex, launches, summary, rep


def phase_words(dev, failures, ex, provider, ds):
    """10c: BeamSearchInference.evaluate_test_set's predictions (9d's call, on
    phase 10's params), frequent_object_map over them, collect_word_stats with
    their TOP_WORDS commonest words (EOS aside) as the categories (img/s,
    launches held to analyze_many's plan), the three ROC-AUCs."""
    from collections import Counter

    from lrp_imagecaptioning_torch.evalx import words as ew
    from lrp_imagecaptioning_torch.infer.api import BeamSearchInference
    from lrp_imagecaptioning_torch.ops import kernels

    inf = BeamSearchInference(ex.captioner, ex.params, provider, beam_size=BEAM,
                              max_caption_length=T, device=dev)
    (_, predictions, _), predict_ms = timed(
        lambda: inf.evaluate_test_set(include_prediction=True))

    id_to_pred = {k: (v[0]["caption"] if isinstance(v, list) else v)
                  for k, v in predictions.items()}
    refs = {d.img_filename: list(d.all_captions_txt) for d in ds.test_set}
    eos = provider.caption_preprocessor.EOS_TOKEN   # the predictions end with it
    cats = [w for w, _ in Counter(w for c in id_to_pred.values() for w in c.split()
                                  if w != eos).most_common(TOP_WORDS)]
    m_ap, map_ms = timed(lambda: ew.frequent_object_map(id_to_pred, refs, cats))
    parts = {}
    timed_method(ex, "analyze_many", parts, keep=lambda out: [len(e.words) for e in out])
    kernels.reset_launches()
    try:
        stats, ms = timed(lambda: ew.collect_word_stats(ex, provider, id_to_pred, cats))
    finally:
        del ex.analyze_many
    launches = counts()
    calls = parts.get("analyze_many:out", [])
    explained = sum(len(w) for w in calls)
    want = explain_launches("adaptiveattention", None, analyze_many_plan(calls, B_TRAIN),
                            decodes=len(calls))
    labels = [int(any(c in r.split() for r in e["true_captions"]))
              for e in stats.values() for c, _ in e["beta"]]
    aucs = {"beta": ew.beta_roc_auc(stats)[2],
            "lrp_mean": ew.mean_roc_auc(stats, "lrp_mean")[2],
            "attention_mean": ew.mean_roc_auc(stats, "attention_mean")[2]}
    rep = dict(predict_ms=predict_ms, categories=cats, frequent_object_map=m_ap, map_ms=map_ms,
               images=explained,
               ms=ms, img_per_s=explained / ms * 1e3, analyze_many_ms=sum(parts["analyze_many"]),
               words=len(labels), positives=sum(labels), roc_auc=aucs, launches=launches,
               expected=want)
    log(f"  mAP over the {TOP_WORDS} commonest predicted words {cats}: {m_ap:.4f} "
        f"({map_ms:.2f} ms); collect_word_stats: {explained} images explained in {ms:.1f} ms = "
        f"{rep['img_per_s']:.2f} img/s (analyze_many {rep['analyze_many_ms']:.1f} ms), "
        f"{len(labels)} words of which {sum(labels)} in the references; ROC-AUC {aucs}; "
        f"launches {launches}")
    if launches != want:
        failures.append(f"10c: launches {launches}, {want} derived from the plan")
    if not stats or len(stats) != explained:
        failures.append(f"10c: {len(stats)} images with stats, {explained} explained")
    return rep


def phase_drivers(dev, failures, cap, params, provider, render):
    """10d: explain_image_file on one JPEG for lrp, deep_taylor and deep_lift
    (ms each, a new Explainer each, its graph captures included), and
    process_beam_search over 4 test images; the figures are rendered where
    the host has matplotlib."""
    from lrp_imagecaptioning_torch.explain import drivers

    pp = provider.caption_preprocessor
    img = provider.dataset.test_set[0].img_path
    stem = os.path.basename(img).split(".")[0]
    rep = {}
    for method in ("lrp", "deep_taylor", "deep_lift"):
        e, ms = timed(lambda: drivers.explain_image_file(cap, params, pp, img, "explain",
                                                         method=method, beam_size=BEAM,
                                                         device=dev))
        files = sorted(os.listdir(os.path.join("explain", stem))) if render else []
        rep[method] = dict(ms=ms, words=len(e.words), files=files)
        log(f"  explain_image_file {method}: {ms:.1f} ms, {len(e.words)} words; figures {files}")
        check_explanations([e], [len(e.words)], f"10d {method}", failures)
        if render and f"{stem}{method}_hm.jpg" not in files:
            failures.append(f"10d {method}: {stem}{method}_hm.jpg was not written")
    res, ms = timed(lambda: drivers.process_beam_search(cap, params, provider, "beam",
                                                        beam_size=BEAM, num_images=4, device=dev))
    check_explanations(res, [len(e.words) for e in res], "10d process_beam_search", failures)
    rep["process_beam_search"] = dict(ms=ms, images=len(res),
                                      folders=sorted(os.listdir("beam")) if render else [])
    log(f"  process_beam_search over {len(res)} images: {ms:.1f} ms")
    if len(res) != 4 or (render and len(rep["process_beam_search"]["folders"]) != 4):
        failures.append(f"10d: process_beam_search gave {rep['process_beam_search']}")
    return rep


def phase_cli(dev, failures, render):
    """10e: cli.main's explain, evaluate-bbox and analyze-words --roc-auc on
    the default device, on the mini-Flickr30k fixture at full width (224x224,
    E = H = 512, the fixture's vocabulary), from an npz of seed-0 params
    whose EOS logit is pushed down (full-length captions); outputs checked as
    tests/test_cli_e2e.py checks them."""
    import contextlib
    import io
    import json

    import yaml

    from lrp_imagecaptioning_torch import cli
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.data.datasets import Flickr30kDataset
    from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k
    from lrp_imagecaptioning_torch.data.provider import DatasetProvider
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.weights import save_params_npz

    write_mini_flickr30k("mini")
    cfg = FlickrConfig(dataset_root="mini", batch_size=4, words_min_occur=1,
                       rare_words_handling="nothing")
    provider = DatasetProvider(Flickr30kDataset(cfg), cfg)
    cap = build_captioner("adaptiveattention", cfg, provider.vocab_size)
    params = cap.init_params(0, device="cpu")
    params["decoder"]["output"]["bias"][provider.caption_preprocessor.EOS_TOKEN_LABEL_ENCODED
                                        - 1] = -30.0
    save_params_npz("mini.npz", params)
    with open("preds.yaml", "w") as f:   # "dog": a frequent object in the first reference
        yaml.safe_dump({"1016887272.jpg": [{"caption": "a green dog"}],
                        "1019077836.jpg": [{"caption": "a dog"}]}, f)
    common = ["--dataset", "flickr30k", "--dataset-root", "mini", "--batch-size", "4",
              "--set", "words_min_occur=1", "--set", "rare_words_handling=nothing",
              "--weights", "mini.npz"]
    img = os.path.join("mini", "Flickr30k_images", "1015118661.jpg")
    runs = [("explain", ["explain", *common, "--image", img, "--out", "cli-explain"]),
            ("evaluate-bbox", ["evaluate-bbox", *common, "--entities-json",
                               os.path.join("mini", "Flickr30kEntities.json"), "--max-images", "2",
                               "--out", "cli-bbox/correctness.json"]),
            ("analyze-words", ["analyze-words", *common, "--predictions", "preds.yaml",
                               "--roc-auc"])]
    rep = {}
    for name, argv in runs:
        out = io.StringIO()
        kernels.reset_launches()
        with contextlib.redirect_stdout(out):
            _, ms = timed(lambda: cli.main(argv))
        rep[name] = dict(ms=ms, launches=counts(), stdout=out.getvalue().strip()[-400:])
        log(f"  cli {name}: {ms:.1f} ms, launches {rep[name]['launches']}; "
            f"{rep[name]['stdout'][-200:]!r}")
        if not any(rep[name]["launches"].values()):
            failures.append(f"10e {name}: launched no kernel on the card")
    rendered = [f for _, _, fs in os.walk("cli-explain") for f in fs]
    if render and not (any(f.endswith("lrp_hm.jpg") for f in rendered)
                       and any(f.endswith("attention.jpg") for f in rendered)):
        failures.append(f"10e explain: figures {rendered}")
    with open("cli-bbox/correctness.json") as f:
        bbox_results = json.load(f)
    if sorted(bbox_results) != ["1016887272.jpg", "1019077836.jpg"] or \
            not os.path.exists("cli-bbox/correctness.csv"):
        failures.append(f"10e evaluate-bbox: results for {sorted(bbox_results)}")
    words_out = rep["analyze-words"]["stdout"]
    if "frequent-object mAP:" not in words_out or "ROC-AUC beta=" not in words_out:
        failures.append(f"10e analyze-words printed {words_out!r}")
    return rep


def phase_word_vectors(dev, failures, cfg, ds):
    """10f: a Trainer with pretrained_word_vector="glove" from a generated
    512-d GloVe file over every other word of the vocabulary: its embedding
    rows for those words equal the file's, on the card."""
    import numpy as np

    from lrp_imagecaptioning_torch.train.trainer import Trainer

    words = [f"w{i:04d}" for i in range(0, VOCAB - 2, 2)]
    vecs = np.random.default_rng(11).standard_normal((len(words), E)).astype(np.float32)
    t0 = time.perf_counter()
    with open("glove.txt", "w") as f:
        for w, row in zip(words, vecs):
            f.write(w + " " + " ".join(f"{v:.9g}" for v in row) + "\n")
    write_s = time.perf_counter() - t0
    cfg_wv = cfg.replace(pretrained_word_vector="glove")
    cfg_wv.word_vector_path = "glove.txt"
    t, ms = timed(lambda: Trainer("adaptiveattention", cfg_wv, ds, label="phase10f",
                                  eval_metrics=False, device=dev))
    emb = t.params["decoder"]["embedding"]
    index = {w: i for i, w in enumerate(t.provider.vocabs)}
    rows = torch.as_tensor([index[w] for w in words], device=dev)
    equal = bool(torch.equal(emb[rows], torch.from_numpy(vecs).to(dev)))
    others = torch.ones(emb.shape[0], dtype=torch.bool, device=dev)
    others[rows] = False
    limit = math.sqrt(6.0 / (emb.shape[0] + emb.shape[1]))
    rest = float(emb[others].abs().max())
    rep = dict(words=len(words), file_mb=os.path.getsize("glove.txt") / 1e6, write_s=write_s,
               trainer_ms=ms, device=str(emb.device), rows_equal=equal, other_rows_max=rest,
               glorot_limit=limit)
    log(f"  {rep}")
    if not equal or emb.device.type != "cuda" or not 0 < rest <= limit:
        failures.append(f"10f: the embedding does not hold the file's rows: {rep}")
    return rep


def phase_explanations(dev, failures, report, handoff, detail):
    """Phase 10 in ``build/phase10`` (removed after), on phase 9's checkpoint
    params and generated dataset, its test images written as JPEGs: 10a-10f.
    Three epochs of phase 9 teach the model the captions' unigram prior, in
    which EOS is the commonest token: it decodes EOS first for every image.
    So the EOS logit's bias is set to -30, and every caption runs to T words.
    Returns the counted launches of the plan paths and their kernel summary."""
    import shutil

    from lrp_imagecaptioning_torch.data.provider import DatasetProvider
    from lrp_imagecaptioning_torch.explain import drivers
    from lrp_imagecaptioning_torch.models.captioner import build_captioner

    work = os.path.join(HERE, "build", "phase10")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    render = report["host"].get("matplotlib", False)
    render_explanation = drivers.render_explanation
    if not render:
        log("  the host has no matplotlib: the drivers' figures are not rendered "
            "(render_explanation is a no-op here); the device work runs as it would")
        drivers.render_explanation = lambda *a, **kw: []
    launches, summary, out = {}, {}, {}
    try:
        cfg, ds, params = handoff["cfg"], handoff["ds"], handoff["params"]
        write_test_jpegs(ds)
        provider = DatasetProvider(ds, cfg)
        bias = params["decoder"]["output"]["bias"]
        bias[provider.caption_preprocessor.EOS_TOKEN_LABEL_ENCODED - 1] = -30.0
        cap = build_captioner("adaptiveattention", cfg, provider.vocab_size)
        images, names = provider_test_images(provider)
        log(f"  {len(names)} test images decoded from JPEG through the provider, "
            f"{images.shape}; vocabulary {provider.vocab_size}")
        pp = provider.caption_preprocessor
        steps = [("10a: deep_taylor and deep_lift, f32, batch 8", "deep"),
                 (f"10b: evaluate-bbox over {len(names)} images at batch {B_TRAIN}", "bbox"),
                 ("10c: analyze-words: frequent-object mAP, word stats, ROC-AUC", "words"),
                 ("10d: the drivers", "drivers"), ("10e: the CLI", "cli"),
                 ("10f: word vectors", "word_vectors")]
        ex = None
        for title, key in steps:
            log(f" phase {title}")
            t0 = time.perf_counter()
            try:
                if key == "deep":
                    launches["deep_taylor"], out[key] = phase_deep_methods(
                        dev, failures, cap, params, pp, images)
                    out[key]["summary"] = summary["deep_taylor"] = plan_summary(
                        dev, "deep_taylor", out[key]["deep_taylor"]["plan"], failures, detail)
                elif key == "bbox":
                    ex, launches["bbox"], summary["bbox"], out[key] = phase_bbox(
                        dev, failures, cap, params, provider, images, names, detail)
                elif key == "words":
                    if ex is None:
                        failures.append(f"phase {title} skipped: 10b did not run")
                    else:
                        out[key] = phase_words(dev, failures, ex, provider, ds)
                elif key == "drivers":
                    out[key] = phase_drivers(dev, failures, cap, params, provider, render)
                elif key == "cli":
                    out[key] = phase_cli(dev, failures, render)
                else:
                    out[key] = phase_word_vectors(dev, failures, cfg, ds)
            except Exception:  # noqa: BLE001 — a sub-phase that raises is recorded as failed
                traceback.print_exc()
                failures.append(f"phase {title} raised")
            log(f"  ({time.perf_counter() - t0:.1f} s)")
            if key == "words":
                ex = None
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        drivers.render_explanation = render_explanation
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return launches, summary, out


# ---------------------------------------------------------------------------
# phase 11: the other configurations at full width (ResNet-101/50, InceptionV3
# with grid-TD, AOA on VGG16, VGG19), random weights from seed 0
# ---------------------------------------------------------------------------
CPU_WORDS_11 = 4    # phase 11's one image against the CPU explains 4 words
# phase 11's decoder-map floors under F64_RATIO, per configuration, on one
# image each (the heatmaps take F64_FLOOR's): f32 rounding alone puts the
# decoder LRP's feat_relevance anywhere from 1e-6 to 4.5e-2 of its scale
# from f64, heavy-tailed over images, on the card and on the CPU alike: over
# 6 images a configuration (two weight seeds), the card lay over 10x the
# CPU's distance in 7 of 60 readings (with the heatmaps') and the CPU over
# 10x the card's in 5 (scripts/config_f64_spread.py; H100 80GB HBM3 at 700
# W). Each floor is 2x the largest reading of either device there; a fault
# that moves an output by O(1) of its scale still fails
F64_FLOOR_CONFIGS = {name: dict(F64_FLOOR, r_feat=floor) for name, floor in (
    ("resnet101", 5e-3),    # largest 2.3e-3
    ("resnet50", 1.3e-3),   # 6.3e-4
    ("inception", 1.6e-2),  # 8.0e-3
    ("aoa", 9e-2),          # 4.5e-2
    ("vgg19", 2.3e-3),      # 1.15e-3
)}


def draw_bn(params, seed):
    """BatchNorm's gamma, beta and moving statistics drawn from ``seed`` in
    place (gamma and the variance in [0.5, 1.5), beta and the mean N(0,
    0.1^2)): under the inits' 1 / 0 / 0 / 1 the BN rule gives back its
    input, and a wrong rule or epsilon would pass unseen."""
    gen = torch.Generator().manual_seed(seed)
    for node in params["vgg"].values():
        for k, v in node.items():
            if k in ("gamma", "bn_gamma", "moving_var", "bn_var"):
                node[k] = (torch.rand(v.shape, generator=gen) + 0.5).to(v.device)
            elif k in ("beta", "bn_beta", "moving_mean", "bn_mean"):
                node[k] = (torch.randn(v.shape, generator=gen) * 0.1).to(v.device)
    return params


def config_model(name, dev):
    """(config, captioner, params) of a phase 11 configuration: FlickrConfig's
    widths (E = H = 512, T = 20), vocab 7003, random weights from seed 0, BN
    statistics drawn."""
    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner

    model, over = CONFIGS[name]
    cfg = FlickrConfig(**over)
    cap = build_captioner(model, cfg, VOCAB)
    return cfg, cap, draw_bn(cap.init_params(seed=0, device=dev), 100)


def config_images(cfg, dev, n, seed=11):
    """``n`` seeded images at the encoder's size: N(0, 1) for VGG and ResNet
    (as phases 3-8), N(0, 0.5^2) for Inception's [-1, 1] inputs."""
    from lrp_imagecaptioning_torch.data.images import encoder_image_size

    size = encoder_image_size(cfg.img_encoder)[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 0.5 if cfg.img_encoder == "inception_v3" else 1.0
    return torch.randn(n, size, size, 3, generator=gen, device=dev) * scale


def four_words(tokens):
    """A 4-word caption: the decode's first words, random ids past its end."""
    import numpy as np

    from lrp_imagecaptioning_torch.explain.engine import _n_explained

    words = list(tokens[:min(_n_explained(tokens, EOS), CPU_WORDS_11)])
    words += list(np.random.default_rng(12).integers(3, VOCAB, CPU_WORDS_11 - len(words)))
    cap = np.zeros(T, np.int32)
    cap[:CPU_WORDS_11] = words
    cap[CPU_WORDS_11] = EOS
    return cap


def counted_run(fn, *args):
    """``fn(*args)`` timed, with the counts set to 0 just before it and read
    just after -> (output, ms, launches)."""
    from lrp_imagecaptioning_torch.ops import kernels

    kernels.reset_launches()
    out, ms = timed(fn, *args)
    return out, ms, counts()


def one_image_methods(cap, params, dev, image, caption, methods, label, failures):
    """Each method on one image with a given caption: a warm call, then a
    counted and timed one; launches against the plan (K3 0 but for VGG's
    deep_taylor), maps finite and not all zero. DeepLIFT through ResNet's
    random weights is let overflow: its relevance grows by Δx W / Δz a conv
    over 100 layers, in the JAX package too (f64: 3.8e61 at ResNet-101 on a
    32x32 input, past f32's range); the share of finite values is logged."""
    out = {}
    for method in methods:
        ex = explainer_for(cap, params, dev, method=method)
        ex.analyze(image, caption)
        e, ms, launches = counted_run(ex.analyze, image, caption)
        want = explain_launches(cap.model_type, None, [(1, bucket_for(CPU_WORDS_11))],
                                method=method, cfg=cap.cfg)
        finite = not (method == "deep_lift" and cap.cfg.img_encoder.startswith("resnet"))
        check_explanations([e], [CPU_WORDS_11], f"{label} {method}", failures,
                           nonzero=method != "guided_gradcam" and finite, size=image.shape[0],
                           finite=finite)
        share = float((abs(e.relevance_maps) < float("inf")).mean())
        out[method] = dict(ms=ms, launches=launches, expected=want, finite_share=share, ex=ex, e=e)
        log(f"  {label} {method}: {ms:.2f} ms for {CPU_WORDS_11} words; launches {launches}; "
            f"finite share of the maps {share:.4f}")
        if launches != want:
            failures.append(f"{label} {method}: launches {launches}, {want} derived")
    return out


def explain_path(path, cap, params, dev, images, storage, label, failures, detail):
    """One counted ``explain_batch_run`` of ``path``, then its kernels timed at
    the run's chunks -> (explainer, explanations, report, launches, summary)."""
    ex, out, rep = explain_batch_run(cap, params, dev, images, storage, label, failures)
    summary = plan_summary(dev, path, rep["plan"], failures, detail)
    return ex, out, rep, rep["launches"], summary


def train_grad_vs_cpu(cap, params, dev, failures, label, mask_seed=13):
    """One train step's loss gradient at batch 1 with dropout 0.5 on the card
    and on the CPU in f32 and f64, one set of masks drawn on the CPU given to
    all three: each leaf's 2-norm distance from f64 within FT_GRAD_RATIO
    times the CPU-f32 run's or TOL_FT_GRAD_L2_FLOOR, as phase 7 holds it."""
    from lrp_imagecaptioning_torch.models.aoa import draw_dropout_masks
    from lrp_imagecaptioning_torch.train.step import value_and_grad
    from lrp_imagecaptioning_torch.weights import tree_leaves, tree_to

    batch = train_batch(torch.Generator(device=dev).manual_seed(14), dev, 1, T_TRAIN)
    params_c = tree_to(params, "cpu")
    masks = draw_dropout_masks(torch.Generator().manual_seed(mask_seed), params_c["decoder"], 1,
                               cap.cfg, 0.5)

    def run(p, images, captions_in, y, m):
        loss, _, grads = value_and_grad(
            lambda q: (cap.loss(q, images, captions_in, y, None, masks=m), None), p)
        return float(loss), [g.cpu().double() for g in tree_leaves(grads)]

    runs = {"card": run(params, *batch, masks.to(dev))}
    cpu = [t.cpu() for t in batch]
    runs["f32"] = run(params_c, *cpu, masks)
    runs["f64"] = run(tree_to(params_c, dtype=torch.float64), cpu[0].double(), cpu[1],
                      cpu[2].double(), masks.to(torch.float64))
    names = leaf_names(params_c)
    # a leaf whose gradient is 0 in exact arithmetic (the key projection's
    # bias: softmax is shift-invariant) is held to 1e-6 of the largest leaf's
    # 2-norm on each run, the others by their own 2-norm
    top = max(float(g.norm()) for g in runs["f64"][1])
    scale = [max(float(g.norm()), 1e-6 * top) for g in runs["f64"][1]]
    l2 = {k: [float((a - b).norm()) / sc for a, b, sc in zip(runs[k][1], runs["f64"][1], scale)]
          for k in ("card", "f32")}
    over = [(n, c, f) for n, c, f in zip(names, l2["card"], l2["f32"])
            if c > max(FT_GRAD_RATIO * f, TOL_FT_GRAD_L2_FLOOR)]
    out = dict(loss={k: v[0] for k, v in runs.items()},
               worst_card=max(zip(l2["card"], names)), worst_f32=max(zip(l2["f32"], names)),
               leaves_over=over)
    log(f"  {label} train-step gradient at batch 1, dropout 0.5, card vs CPU: {out}")
    if over or not math.isfinite(out["loss"]["card"]):
        failures.append(f"{label}: gradient leaves (leaf, card, CPU f32) 2-norm distances from "
                        f"f64 over {FT_GRAD_RATIO}x and {TOL_FT_GRAD_L2_FLOOR}: {over}")
    return out


def phase_configs(dev, failures, detail):
    """11a-11d. Returns (launches, kernel summaries) of the phase's paths."""
    import numpy as np

    launches, summary, rep = {}, {}, {}

    def section(title, fn):
        log(f" phase {title}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — a sub-phase that raises is recorded as failed
            traceback.print_exc()
            failures.append(f"phase {title} raised")
        log(f"  ({time.perf_counter() - t0:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()

    def resnet():
        cfg, cap, params = config_model("resnet101", dev)
        images = config_images(cfg, dev, B_MAIN)
        ex, out, r, launches["resnet101_f32"], summary["resnet101_f32"] = explain_path(
            "resnet101_f32", cap, params, dev, images, None, "11a resnet101 lrp", failures,
            detail)
        caption = four_words(out[0].tokens_1based)
        r["methods"] = {m: {k: v for k, v in o.items() if k not in ("ex", "e")}
                        for m, o in one_image_methods(
                            cap, params, dev, images[0], caption,
                            ("deep_taylor", "deep_lift", "gradient", "guided_gradcam"),
                            "11a", failures).items()}
        r["cpu"] = card_vs_cpu(ex, cap, params, images[0], out[0].tokens_1based, failures,
                               "11a resnet101", words=CPU_WORDS_11, caption=caption,
                               floor=F64_FLOOR_CONFIGS["resnet101"])
        del ex, out, params
        gc.collect()
        _, cap50, params50 = config_model("resnet50", dev)
        ex50 = explainer_for(cap50, params50, dev)
        toks50 = ex50.predict_caption(images[0])[0]
        r["cpu_resnet50"] = card_vs_cpu(ex50, cap50, params50, images[0], toks50, failures,
                                        "11a resnet50", caption=caption,
                                        floor=F64_FLOOR_CONFIGS["resnet50"])
        rep["resnet"] = r

    def inception():
        cfg, cap, params = config_model("inception", dev)
        images = config_images(cfg, dev, B_MAIN)
        ex, out, r, launches["inception_f32"], summary["inception_f32"] = explain_path(
            "inception_f32", cap, params, dev, images, None, "11b inception lrp", failures,
            detail)
        caption = four_words(out[0].tokens_1based)
        sg = one_image_methods(cap, params, dev, images[0], caption, ("smoothgrad",), "11b",
                               failures)["smoothgrad"]
        r["smoothgrad"] = dict(ms=sg["ms"], launches=sg["launches"],
                               cpu=grad_vs_cpu(sg["ex"], cap, params, images[0], caption,
                                               sg["e"], failures, label="11b"))
        r["cpu"] = card_vs_cpu(ex, cap, params, images[0], out[0].tokens_1based, failures,
                               "11b inception", words=CPU_WORDS_11, caption=caption,
                               floor=F64_FLOOR_CONFIGS["inception"])
        rep["inception"] = r

    def aoa():
        from lrp_imagecaptioning_torch.train.lrp_finetune import make_lrp_finetune_step
        from lrp_imagecaptioning_torch.train.optimizer import make_optimizer
        from lrp_imagecaptioning_torch.train.step import make_train_step

        cfg, cap, params = config_model("aoa", dev)
        images = config_images(cfg, dev, B_BF16)
        r = {}
        ex = explainer_for(cap, params, dev, batch_size=B_BF16)
        ex._decode(images)
        toks, ms, counted = counted_run(ex._decode, images)
        r["decode"] = dict(ms=ms, img_per_s=B_BF16 / ms * 1e3, launches=counted,
                           words=[int(np.sum((t != 0) & (t != EOS))) for t in toks[:8]])
        log(f"  11c beam decode of {B_BF16} images: {ms:.1f} ms = {r['decode']['img_per_s']:.2f} "
            f"img/s; launches {counted}")
        if counted != explain_launches("aoa", None, [], decodes=1, cfg=cfg):
            failures.append(f"11c decode: launches {counted}")
        del ex
        ex8, out8, r["f32"], launches["aoa_f32"], summary["aoa_f32"] = explain_path(
            "aoa_f32", cap, params, dev, images[:B_MAIN], None, "11c aoa lrp f32", failures,
            detail)
        r["cpu"] = card_vs_cpu(ex8, cap, params, images[0], out8[0].tokens_1based, failures,
                               "11c aoa", floor=F64_FLOOR_CONFIGS["aoa"])
        del ex8, out8
        gc.collect()
        torch.cuda.empty_cache()
        _, _, r["bf16"], launches["aoa_bf16"], summary["aoa_bf16"] = explain_path(
            "aoa_bf16", cap, params, dev, images, torch.bfloat16, "11c aoa lrp bf16", failures,
            detail)
        gc.collect()
        torch.cuda.empty_cache()
        # a train step at batch 32 (dropout 0.5), then a fine-tune step at batch 8
        batch = train_batch(torch.Generator(device=dev).manual_seed(15), dev, B_TRAIN, T_TRAIN)
        opt = make_optimizer("aoa", cfg.learning_rate)
        assert opt.b1 == 0.9
        torch.cuda.reset_peak_memory_stats()
        p, _, records = counted_steps(make_train_step(cap, opt), 2, params, opt.init(params),
                                      batch, torch.Generator(device=dev).manual_seed(16),
                                      expected_launches("train", cfg), failures, "11c aoa_train")
        launches["aoa_train"] = records[-1]["launches"]
        r["train"] = dict(steps=records, ms_per_step=records[-1]["ms"],
                          img_per_s=B_TRAIN / records[-1]["ms"] * 1e3, **memory_gib())
        del p, batch
        ft_cfg = cfg.replace(batch_size=B_MAIN)
        batch = train_batch(torch.Generator(device=dev).manual_seed(17), dev, B_MAIN, T_TRAIN)
        step = make_lrp_finetune_step(cap, make_optimizer("aoa", 1e-6),
                                      np.zeros(VOCAB + 1, bool), SOS, EOS, "mean")
        _, _, ft = counted_steps(step, 1, params, make_optimizer("aoa", 1e-6).init(params), batch,
                                 torch.Generator(device=dev).manual_seed(18),
                                 expected_launches("aoa_finetune", ft_cfg), failures,
                                 "11c aoa finetune")
        r["finetune"] = dict(steps=ft, ms=ft[-1]["ms"], img_per_s=B_MAIN / ft[-1]["ms"] * 1e3)
        del batch
        r["train_grad_cpu"] = train_grad_vs_cpu(cap, params, dev, failures, "11c aoa")
        rep["aoa"] = r

    def vgg19():
        cfg, cap, params = config_model("vgg19", dev)
        images = config_images(cfg, dev, B_BF16)
        r = {}
        ex, out, r["f32"], launches["vgg19_f32"], summary["vgg19_f32"] = explain_path(
            "vgg19_f32", cap, params, dev, images[:B_MAIN], None, "11d vgg19 lrp f32", failures,
            detail)
        r["cpu"] = card_vs_cpu(ex, cap, params, images[0], out[0].tokens_1based, failures,
                               "11d vgg19", floor=F64_FLOOR_CONFIGS["vgg19"])
        del ex, out
        gc.collect()
        torch.cuda.empty_cache()
        _, _, r["bf16"], launches["vgg19_bf16"], summary["vgg19_bf16"] = explain_path(
            "vgg19_bf16", cap, params, dev, images, torch.bfloat16, "11d vgg19 lrp bf16",
            failures, detail)
        rep["vgg19"] = r

    for title, fn in (("11a: ResNet-101 + adaptive attention, f32 batch 8; ResNet-50", resnet),
                      ("11b: InceptionV3 + grid-TD, f32 batch 8, 299x299", inception),
                      ("11c: AOA on VGG16: decode, f32 and bf16 lrp, train and fine-tune", aoa),
                      ("11d: VGG19 + adaptive attention at block5_conv4, f32 and bf16", vgg19)):
        section(title, fn)
    return launches, summary, rep


# ---------------------------------------------------------------------------
# phase 12: the serving entry points at full width (VGG16 + adaptive
# attention, random weights from seed 0): CaptionService, the HTTP and gRPC
# front-ends, the torch.export artifact, the CLI's serve
# ---------------------------------------------------------------------------
N_CLIENTS = 16              # concurrent single-image clients of 12b and 12c
LINGER_MS = 5.0             # the queue's window (the CLI's default)
CLI_SERVE_S = 5             # --serve-seconds of 12e's servers
# the exported explain programs' word buckets: every bucket, unless
# exporting them all takes over 120 s on the card. It took 212.4 s (25.7 s
# the decode, 33-40 s each explain program; H100 80GB HBM3 at 700 W), so
# 12g exports (8,) and T. 12d and 12f export T alone (12d's captions take
# all T words, so the counted request never ran its bucket 8): with 12d at
# (8,) + T and 12f, the whole smoke took 1109.8 s of its 1200 on a slow
# host (12d 216.0 s, 12f 131.5; H100 80GB HBM3 at 700 W)
EXPORT_BUCKETS = (8,)
# 12b/12c: a coalesced request explains its image inside a batch of up to
# B_MAIN rows where the direct reference runs it alone: held to the entry
# points' batch-size bound, TOL_CONSISTENT_LRP, beyond one float16 spacing
# of the payload (the random weights' heatmaps sit in float16's subnormal
# range, values 6e-8 apart, where one rounding flip alone was 0.25 of their
# scale). An H100 80GB HBM3 at 700 W read 1.4e-4; on phase 9's trained
# checkpoint (its heatmaps still in float16's subnormals, scale 4.3e-5 to
# 4.6e-5) 2.7e-5 to 4.8e-5 over three runs, 8.3e-4 to 8.7e-4 without the
# spacing (scripts/config_f64_spread.py --phase9). An uncoalesced request is
# held bit for bit
TOL_SERVE_F16 = TOL_CONSISTENT_LRP
# 12a/12d: the same ops on the same shapes. On the card the heatmaps are not
# bit for bit from run to run (analyze_batch against itself read 1.8e-7 of
# scale, the other arrays 0): they are held within this, the rest exactly
TOL_EXPORTED = 1e-6
# 12f: the gradient method the whole run exports (Guided-GradCAM, one of the
# reference's four headline explainers) and its word buckets: one program at
# T. A gradient program holds B_MAIN images' forwards and backwards, IG's
# 16 and SmoothGrad's 8 passes an image each, so ``--only export_grad``
# (12g) alone exports every method, at EXPORT_BUCKETS and T
GRAD_EXPORT = ("guided_gradcam", ())


def export_grad_check(dev, failures, cap, params, images, work, method, buckets, label):
    """``export_serving`` of a gradient method at B_MAIN (``make_fx``, then
    ``torch.export``; every program must call ``lrpic::lstm_gates``),
    ``ExportedService`` (its warm-up captures every program's graph), one
    counted explain request of ``images``: tokens equal the live Explainer's
    ``analyze_batch``, every array within TOL_EXPORTED of its scale or twice
    the live call's distance from itself, whichever is larger, K2's
    launches as derived (the decode's beam search and the program's cached
    forward, T each), the graphs unchanged by the request. -> report"""
    import numpy as np

    from lrp_imagecaptioning_torch.explain.engine import Explainer
    from lrp_imagecaptioning_torch.infer.export import ExportedService, export_serving

    out = os.path.join(work, f"artifact_{method}")
    _, export_ms = timed(lambda: export_serving(
        cap, params, CaptionPP(), out, batch_size=B_MAIN, beam_size=BEAM, max_len=T,
        method=method, word_buckets=buckets, device=dev))
    with open(os.path.join(out, "export.json")) as f:
        programs = json.load(f)
    esvc, load_ms = timed(lambda: ExportedService(out, device=dev))
    before = esvc.graph_stats()
    got, ms, counted = counted_run(lambda: esvc.dispatch(images, explain=True))
    after = esvc.graph_stats()
    warmup_s = esvc.stats.get("warmup_s")
    del esvc
    words = [len(e.words) for e in got]
    plan = [(len(images), min(w for w in (*buckets, T) if w >= max(max(words), 1)))]
    want = explain_launches("adaptiveattention", None, plan, decodes=1, method=method)
    ex = Explainer(cap, params, CaptionPP(), method, beam_size=BEAM, max_len=T,
                   word_buckets=buckets, batch_size=B_MAIN, device=dev)
    first = ex.analyze_batch(images)   # its first call captures and pays cuDNN's first calls
    ref, live_ms = timed(ex.analyze_batch, images)
    del ex
    # cuDNN's backward convs may sum in a varying order: the live path
    # against itself bounds what the same ops can give
    spread = explanation_dist(first, ref)
    tol = {f: max(TOL_EXPORTED, 2 * d) for f, d in spread.items()}
    dist = explanation_dist(got, ref)
    tokens = all(np.array_equal(g.tokens_1based, r.tokens_1based) for g, r in zip(got, ref))
    exact = same_explanations(got, ref, EXPLANATION_FIELDS)
    check_explanations(got, words, f"{label} exported {method}", failures,
                       nonzero=method != "guided_gradcam", size=images.shape[1])
    if not tokens or any(d > tol[f] for f, d in dist.items()):
        failures.append(f"{label} exported {method} vs the live Explainer: tokens equal "
                        f"{tokens}, distances {dist}, tolerances {tol}")
    if counted != want:
        failures.append(f"{label} exported {method}: launches {counted}, {want} derived")
    if after != before:
        failures.append(f"{label} exported {method}: the request changed the graphs: {before} "
                        f"-> {after}")
    rep = dict(method=method, buckets=list(buckets), export_s=export_ms / 1e3,
               programs=programs, load_warmup_s=load_ms / 1e3, warmup_s=warmup_s,
               explain_ms=ms, explain_img_per_s=len(images) / ms * 1e3, live_ms=live_ms,
               live_img_per_s=len(images) / live_ms * 1e3, words=words, plan=plan,
               launches=counted, expected=want, tokens_equal=tokens, bit_for_bit=exact,
               dist=dist, live_run_to_run=spread, tolerance=tol, graphs_after_warmup=before,
               graphs_after_requests=after,
               pool_gib=after["pool_bytes"] / 2**30)
    log(f"  {label} export_serving({method}) at batch {B_MAIN}, buckets {list(buckets)} + T: "
        f"{export_ms / 1e3:.1f} s ({programs['seconds']}; bytes {programs['bytes']}); load + "
        f"warmup {load_ms / 1e3:.1f} s; explain of {len(images)} {ms:.1f} ms = "
        f"{rep['explain_img_per_s']:.2f} img/s exported against {live_ms:.1f} ms = "
        f"{rep['live_img_per_s']:.2f} img/s live (words {words}); launches {counted}; graphs "
        f"{before} -> {after}; against the live Explainer: tokens equal {tokens}, bit for bit "
        f"{exact}, {dist}; live against itself {spread}")
    return rep


def phase_export_grad(dev, failures):
    """12g (``--only export_grad``): every gradient method exported at
    EXPORT_BUCKETS and T and held as 12f holds guided_gradcam, in
    ``build/phase12g`` (removed after)."""
    import shutil

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner

    work = os.path.join(HERE, "build", "phase12g")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cap = build_captioner("adaptiveattention", FlickrConfig(), VOCAB)
    params = cap.init_params(seed=0, device=dev)
    images = serve_images(B_MAIN, 12)
    reps = {}
    for method in GRAD_METHODS:
        t0 = time.perf_counter()
        try:
            reps[method] = export_grad_check(dev, failures, cap, params, images, work, method,
                                             EXPORT_BUCKETS, "12g")
        except Exception:  # noqa: BLE001 — a method that raises is recorded as failed
            traceback.print_exc()
            failures.append(f"12g {method} raised")
        log(f"  ({time.perf_counter() - t0:.1f} s; {host_gib()})")
        shutil.rmtree(os.path.join(work, f"artifact_{method}"), ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return reps


def serve_images(n, seed):
    """``n`` N(0, 1) images as the host's float32 arrays (what clients send)."""
    import numpy as np

    return np.random.default_rng(seed).normal(size=(n, IMAGE, IMAGE, 3)).astype(np.float32)


def f16_dist(payload, ref):
    """The largest distance of a float16 payload array from the float32
    reference, less one float16 spacing at the reference's value (a
    rounding that the f32 difference flipped), over the reference's scale."""
    import numpy as np

    a = np.asarray(payload, np.float32)
    b = np.asarray(ref, np.float32)
    if a.shape != b.shape:
        return float("inf")
    if not b.size:
        return 0.0
    spacing = np.spacing(np.abs(b).astype(np.float16)).astype(np.float32)
    excess = np.maximum(np.abs(a - b) - spacing, 0.0)
    return float(excess.max()) / max(float(np.abs(b).max()), 1e-30)


def answer_dist(answer, ref):
    """An explain answer {caption, words, relevance_maps, word_relevances}
    against a direct Explanation: inf where the words differ, else the
    largest float16 distance of the two arrays."""
    if answer["caption"] != ref.caption or list(answer["words"]) != list(ref.words):
        return float("inf")
    return max(f16_dist(answer["relevance_maps"], ref.relevance_maps),
               f16_dist(answer["word_relevances"], ref.word_relevances))


def npz_answer(body, i=0):
    import io

    import numpy as np

    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {"caption": str(z[f"caption_{i}"]), "words": [str(w) for w in z[f"words_{i}"]],
                "relevance_maps": z[f"relevance_maps_{i}"],
                "word_relevances": z[f"word_relevances_{i}"]}


def http_explain(port, image, timeout=300):
    """POST one image as .npy to /explain -> (answer, seconds)."""
    import io
    import urllib.request

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, image[None])
    req = urllib.request.Request(f"http://127.0.0.1:{port}/explain?method=lrp",
                                 data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npy"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
    return npz_answer(body), time.perf_counter() - t0


def concurrent_clients(call, images):
    """``call(image)`` -> answer on one thread per image, all released
    together -> (answers, per-request seconds, wall seconds)."""
    import threading

    n = len(images)
    answers, lat, errors = [None] * n, [0.0] * n, []
    gate = threading.Barrier(n + 1)

    def client(i):
        gate.wait()
        t0 = time.perf_counter()
        try:
            answers[i] = call(images[i])
        except Exception as e:  # noqa: BLE001 — reported to the phase
            errors.append(f"client {i}: {type(e).__name__}: {e}")
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"clients failed: {errors[:3]}")
    return answers, lat, wall


def latency_summary(lat, wall):
    import numpy as np

    ms = np.asarray(lat) * 1e3
    return dict(p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                max_ms=float(ms.max()), requests_per_s=len(lat) / wall, wall_s=wall)


def same_explanations(got, ref, fields=EXPLANATION_FIELDS):
    """Tokens, words and each of ``fields`` of ``got`` bit for bit ``ref``'s."""
    import numpy as np

    return all(g.caption == r.caption and g.words == r.words
               and np.array_equal(g.tokens_1based, r.tokens_1based)
               and all(np.array_equal(getattr(g, f), getattr(r, f)) for f in fields)
               for g, r in zip(got, ref)) and len(got) == len(ref)


def held_to(got, ref, label, failures):
    """12a/12d: tokens, words and every array but the heatmaps bit for bit,
    the heatmaps within TOL_EXPORTED of their scale -> the distances."""
    dist = explanation_dist(got, ref)
    exact = same_explanations(got, ref, EXPLANATION_FIELDS[1:])
    if not exact or dist["relevance_maps"] > TOL_EXPORTED:
        failures.append(f"{label}: bit for bit but the heatmaps {exact}, distances {dist}")
    return dict(exact_but_maps=exact, dist=dist)


def serve_launch_check(label, launches, words, storage_dtype, failures):
    """One explain request of len(words) images at B_MAIN: its plan and the
    launches it derives (one beam search, one chunk)."""
    plan = sorted_plan(words, B_MAIN)
    want = explain_launches("adaptiveattention", storage_dtype, plan, decodes=1)
    if launches != want:
        failures.append(f"{label}: launches {launches}, {want} derived")
    return plan, want


def phase_serve_live(dev, failures, cap, params, images, storage_dtype=None, label="12a"):
    """A warmed CaptionService at B_MAIN: one caption and one explain request
    of len(images), counted; the graphs unchanged by them."""
    from lrp_imagecaptioning_torch.infer.serving import CaptionService

    svc = CaptionService(cap, params, CaptionPP(), batch_size=B_MAIN, beam_size=BEAM, max_len=T,
                         storage_dtype=storage_dtype, device=dev)
    _, warm_ms = timed(lambda: svc.warmup(explain=True))
    before = svc.graph_stats()
    caps, cap_ms, cap_launches = counted_run(svc.caption, images)
    exps, ms, launches = counted_run(svc.explain, images)
    after = svc.graph_stats()
    words = [len(e.words) for e in exps]
    plan, want = serve_launch_check(f"{label} explain", launches, words, storage_dtype, failures)
    check_explanations(exps, words, f"{label} explain", failures, size=images.shape[1])
    if cap_launches != explain_launches("adaptiveattention", None, [], decodes=1):
        failures.append(f"{label} caption: launches {cap_launches}")
    if caps != [" ".join(e.words) for e in exps]:
        failures.append(f"{label}: captions {caps[:2]} differ from the explanations' words")
    if after != before:
        failures.append(f"{label}: requests after warmup changed the graphs: {before} -> {after}")
    rep = dict(storage_dtype=str(storage_dtype), warmup_ms=warm_ms, caption_ms=cap_ms,
               caption_img_per_s=len(images) / cap_ms * 1e3, caption_launches=cap_launches,
               explain_ms=ms, explain_img_per_s=len(images) / ms * 1e3, words=words, plan=plan,
               launches=launches, expected=want, graphs_after_warmup=before,
               graphs_after_requests=after, pool_gib=after["pool_bytes"] / 2**30, **memory_gib())
    log(f"  {label} CaptionService {rep['storage_dtype']} at {B_MAIN}: warmup {warm_ms:.1f} ms; "
        f"caption of {len(images)} {cap_ms:.1f} ms = {rep['caption_img_per_s']:.2f} img/s; "
        f"explain {ms:.1f} ms = {rep['explain_img_per_s']:.2f} img/s (words {words}); launches "
        f"{launches}; graphs {before} -> {after}")
    return svc, exps, rep


def phase_serve(dev, failures, detail):
    """12a-12f. Returns (launches, kernel summaries, report) of the paths
    serve_f32, serve_bf16, exported and exported_grad."""
    import shutil

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner

    work = os.path.join(HERE, "build", "phase12")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches, summary, rep = {}, {}, {}
    cap = build_captioner("adaptiveattention", FlickrConfig(), VOCAB)
    params = cap.init_params(seed=0, device=dev)
    images = serve_images(B_MAIN, 12)
    clients = serve_images(N_CLIENTS, 13)
    state = {}

    def section(title, fn):
        log(f" phase {title}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — a sub-phase that raises is recorded as failed
            traceback.print_exc()
            failures.append(f"phase {title} raised")
        log(f"  ({time.perf_counter() - t0:.1f} s; {host_gib()})")
        gc.collect()
        torch.cuda.empty_cache()

    def live():
        svc, exps, rep["live"] = phase_serve_live(dev, failures, cap, params, images)
        launches["serve_f32"] = rep["live"]["launches"]
        summary["serve_f32"] = plan_summary(dev, "serve_f32", rep["live"]["plan"], failures,
                                            detail)
        ex = explainer_for(cap, params, dev, batch_size=B_MAIN)
        ref = ex.analyze_batch(images)
        r = rep["live"]["vs_analyze_batch"] = held_to(exps, ref, "12a vs analyze_batch", failures)
        r["analyze_batch_run_to_run"] = explanation_dist(ex.analyze_batch(images), ref)
        log(f"  12a explain vs Explainer.analyze_batch on the same images: all but the heatmaps "
            f"bit for bit {r['exact_but_maps']}; distances {r['dist']}; analyze_batch against "
            f"itself {r['analyze_batch_run_to_run']}")
        del ex
        state.update(svc=svc, exps=exps)
        gc.collect()
        _, _, rep["live_bf16"] = phase_serve_live(dev, failures, cap, params, images,
                                                  torch.bfloat16, "12a bf16")
        launches["serve_bf16"] = rep["live_bf16"]["launches"]
        summary["serve_bf16"] = plan_summary(dev, "serve_bf16", rep["live_bf16"]["plan"],
                                             failures, detail)

    def direct_refs():
        """Each client image explained alone, directly (queue stopped)."""
        svc = state["svc"]
        svc.stop_queue()
        state["direct"] = [svc.explain(clients[i:i + 1])[0] for i in range(N_CLIENTS)]
        return state["direct"]

    def http():
        from lrp_imagecaptioning_torch.infer.http_server import CaptionHTTPServer, npz_payload

        svc = state["svc"]
        direct = direct_refs()
        one, direct_ms = timed(svc.explain, clients[:1])
        server = CaptionHTTPServer(svc, port=0).start()
        try:
            # what the npz encoding and the HTTP copy add to one request
            _, http_s = http_explain(server.port, clients[0])
            _, http_s = http_explain(server.port, clients[0])
            body, npz_s = timed(npz_payload, one)
            r = dict(direct_ms=direct_ms, http_ms=http_s * 1e3, npz_ms=npz_s,
                     npz_bytes=len(body))
            # 16 concurrent clients with the queue running: coalesced
            svc.start_queue(linger_ms=LINGER_MS)
            n0 = svc.stats["requests"]
            answers, lat, wall = concurrent_clients(lambda im: http_explain(server.port, im)[0],
                                                    clients)
            r["queued"] = dict(dispatches=svc.stats["requests"] - n0,
                               worst=max(answer_dist(a, d) for a, d in zip(answers, direct)),
                               **latency_summary(lat, wall))
            # and with the queue stopped: direct dispatches under the service's lock
            svc.stop_queue()
            n0 = svc.stats["requests"]
            answers, lat, wall = concurrent_clients(lambda im: http_explain(server.port, im)[0],
                                                    clients)
            r["direct"] = dict(dispatches=svc.stats["requests"] - n0,
                               worst=max(answer_dist(a, d) for a, d in zip(answers, direct)),
                               **latency_summary(lat, wall))
        finally:
            server.stop()
        rep["http"] = r
        log(f"  12b one image: direct explain {direct_ms:.1f} ms, over HTTP {r['http_ms']:.1f} ms, "
            f"of which the npz payload's encoding {npz_s:.1f} ms ({len(body)} bytes)")
        for mode in ("queued", "direct"):
            q = r[mode]
            log(f"  12b {N_CLIENTS} concurrent HTTP clients, queue {mode}: {q['dispatches']} "
                f"dispatches; p50 {q['p50_ms']:.1f} ms, p99 {q['p99_ms']:.1f} ms, "
                f"{q['requests_per_s']:.2f} requests/s; worst answer {q['worst']:.3e} of scale")
        if r["queued"]["worst"] > TOL_SERVE_F16:
            failures.append(f"12b queued answers differ from the direct ones: {r['queued']['worst']}")
        if r["direct"]["worst"] != 0.0:
            failures.append(f"12b answers with the queue stopped differ from the direct ones: "
                            f"{r['direct']['worst']}")
        if r["direct"]["dispatches"] != N_CLIENTS:
            failures.append(f"12b: {r['direct']['dispatches']} dispatches without the queue")

    def grpc():
        import importlib.util

        if importlib.util.find_spec("grpc") is None:
            log("  grpcio is absent on this host: 12c not run")
            rep["grpc"] = "grpcio absent"
            return
        from lrp_imagecaptioning_torch.infer.grpc_server import (CaptionGrpcClient,
                                                                  CaptionGrpcServer,
                                                                  CaptionGrpcTypedClient)

        svc = state["svc"]
        direct = state.get("direct") or direct_refs()
        server = CaptionGrpcServer(svc, port=0, max_workers=N_CLIENTS).start()
        svc.start_queue(linger_ms=LINGER_MS)
        target = f"127.0.0.1:{server.port}"
        raw, typed = CaptionGrpcClient(target), CaptionGrpcTypedClient(target)
        r = {"typed_registered": server.typed}
        try:
            def raw_call(im):
                z = raw.explain(im[None], "lrp")
                return {"caption": str(z["caption_0"]), "words": [str(w) for w in z["words_0"]],
                        "relevance_maps": z["relevance_maps_0"],
                        "word_relevances": z["word_relevances_0"]}

            for name, call in (("raw", raw_call), ("typed", lambda im: typed.explain(im[None],
                                                                                    "lrp")[0])):
                n0 = svc.stats["requests"]
                answers, lat, wall = concurrent_clients(call, clients)
                r[name] = dict(dispatches=svc.stats["requests"] - n0,
                               worst=max(answer_dist(a, d) for a, d in zip(answers, direct)),
                               **latency_summary(lat, wall))
                log(f"  12c gRPC {name}, {N_CLIENTS} concurrent clients, queue running: "
                    f"{r[name]['dispatches']} dispatches; p50 {r[name]['p50_ms']:.1f} ms, p99 "
                    f"{r[name]['p99_ms']:.1f} ms, {r[name]['requests_per_s']:.2f} requests/s; "
                    f"worst answer {r[name]['worst']:.3e} of scale")
                if r[name]["worst"] > TOL_SERVE_F16:
                    failures.append(f"12c {name} answers differ from the direct ones: "
                                    f"{r[name]['worst']}")
            r["captions"] = raw.caption(images) == typed.caption(images) == \
                [" ".join(e.words) for e in state["exps"]]
            if not r["captions"]:
                failures.append("12c: gRPC captions differ from 12a's")
        finally:
            raw.close()
            typed.close()
            svc.stop_queue()
            server.stop()
        rep["grpc"] = r

    def exported():
        from lrp_imagecaptioning_torch.infer.export import ExportedService, export_serving

        out = os.path.join(work, "artifact")
        _, export_ms = timed(lambda: export_serving(
            cap, params, CaptionPP(), out, batch_size=B_MAIN, beam_size=BEAM, max_len=T,
            method="lrp", word_buckets=(), device=dev))
        with open(os.path.join(out, "export.json")) as f:
            programs = json.load(f)
        esvc, load_ms = timed(lambda: ExportedService(out, device=dev))
        before = esvc.graph_stats()
        caps = esvc.dispatch(images)
        got, ms, counted = counted_run(lambda: esvc.dispatch(images, explain=True))
        after = esvc.graph_stats()
        words = [len(e.words) for e in got]
        plan, want = serve_launch_check("12d exported explain", counted, words, None, failures)
        launches["exported"] = counted
        summary["exported"] = plan_summary(dev, "exported", plan, failures, detail)
        ref = state["exps"]
        held = held_to(got, ref, "12d exported vs 12a", failures)
        rep["exported"] = dict(export_s=export_ms / 1e3, programs=programs, load_warmup_s=load_ms
                               / 1e3, warmup_s=esvc.stats.get("warmup_s"), explain_ms=ms,
                               explain_img_per_s=len(images) / ms * 1e3, launches=counted,
                               expected=want, graphs_after_warmup=before,
                               graphs_after_requests=after, **held)
        log(f"  12d export_serving at batch {B_MAIN}, one program at T: "
            f"{export_ms / 1e3:.1f} s ({programs['seconds']}; bytes {programs['bytes']}); "
            f"load + warmup {load_ms / 1e3:.1f} s; explain of {len(images)} {ms:.1f} ms = "
            f"{rep['exported']['explain_img_per_s']:.2f} img/s; launches {counted}; graphs "
            f"{before} -> {after}; against 12a: all but the heatmaps bit for bit "
            f"{held['exact_but_maps']}, {held['dist']}")
        if caps != [" ".join(e.words) for e in ref]:
            failures.append("12d: the exported captions differ from 12a's")
        if after != before:
            failures.append(f"12d: requests after warmup changed the graphs: {before} -> {after}")
        state["artifact"] = out
        del esvc

    def exported_grad():
        method, buckets = GRAD_EXPORT
        r = rep["exported_grad"] = export_grad_check(dev, failures, cap, params, images, work,
                                                     method, buckets, "12f")
        launches["exported_grad"] = r["launches"]
        summary["exported_grad"] = plan_summary(dev, "exported_grad", r["plan"], failures,
                                                detail)

    def cli():
        rep["cli"] = phase_serve_cli(work, state, images[0], failures)

    state["svc"] = None
    for title, fn in (("12a: CaptionService, f32 and bf16, batch 8", live),
                      (f"12b: the HTTP front-end, {N_CLIENTS} concurrent clients", http),
                      (f"12c: the gRPC front-end, {N_CLIENTS} concurrent clients", grpc),
                      ("12d: export_serving and ExportedService", exported),
                      (f"12f: export_serving of {GRAD_EXPORT[0]} and ExportedService",
                       exported_grad),
                      ("12e: the CLI's serve, live and --exported", cli)):
        if fn is not live and state["svc"] is None:
            failures.append(f"phase {title} skipped: 12a did not run")
            continue
        section(title, fn)
    # 14e reuses the artifact (exporting again costs ~106 s a pair of
    # buckets); main removes the directory after the phases
    rep["artifact"] = state.get("artifact")
    state.clear()
    for name in os.listdir(work):
        if os.path.join(work, name) != rep["artifact"]:
            shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    return launches, summary, rep


def serve_subprocess(argv, cwd, image, label, failures):
    """``cli serve ... --port 0`` in a child process: wait for its port, send
    one /explain request, let it exit after --serve-seconds (killed past a
    deadline) -> (answer or None, report)."""
    import threading

    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "lrp_imagecaptioning_torch.cli", "serve", *argv, "--port", "0",
           "--serve-seconds", str(CLI_SERVE_S)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, port = [], []
    ready = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "serving on http://" in line and not port:
                port.append(int(line.split("http://", 1)[1].split()[0].rsplit(":", 1)[1]))
                ready.set()
        ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    answer, r = None, {}
    try:
        ready.wait(timeout=300)
        r["start_s"] = time.perf_counter() - t0
        if port:
            answer, s = http_explain(port[0], image)
            r["request_ms"] = s * 1e3
        proc.wait(timeout=CLI_SERVE_S + 120)
    except Exception:  # noqa: BLE001 — reported below
        traceback.print_exc()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    r.update(rc=proc.returncode, tail=lines[-6:])
    log(f"  12e {label}: rc {proc.returncode}, serving after {r.get('start_s', 0):.1f} s, "
        f"one /explain {r.get('request_ms', float('nan')):.1f} ms; {lines[-3:]}")
    if proc.returncode != 0 or answer is None:
        failures.append(f"12e {label}: rc {proc.returncode}, answer {answer is not None}; "
                        f"{lines[-10:]}")
    return answer, r


def phase_serve_cli(work, state, image, failures):
    """12e: ``serve --with-explain`` on the mini-Flickr30k fixture at full
    width (seed-0 params), and ``serve --exported`` over 12d's artifact
    (answer equal to 12a's first explanation), one /explain request each."""
    from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k

    rep = {}
    write_mini_flickr30k(os.path.join(work, "mini"))
    live_argv = ["--dataset", "flickr30k", "--dataset-root", "mini", "--batch-size",
                 str(B_MAIN), "--set", "words_min_occur=1", "--set",
                 "rare_words_handling=nothing", "--with-explain"]
    answer, rep["live"] = serve_subprocess(live_argv, work, image, "serve", failures)
    if answer is not None and len(answer["words"]) != answer["relevance_maps"].shape[0]:
        failures.append(f"12e serve: {len(answer['words'])} words, maps "
                        f"{answer['relevance_maps'].shape}")
    if "artifact" not in state:
        failures.append("12e serve --exported skipped: 12d did not run")
        return rep
    answer, rep["exported"] = serve_subprocess(["--exported", state["artifact"], "--with-explain"],
                                               work, image, "serve --exported", failures)
    if answer is not None:
        rep["exported"]["dist"] = answer_dist(answer, state["exps"][0])
        if rep["exported"]["dist"] > TOL_EXPORTED:
            failures.append(f"12e serve --exported: answer {rep['exported']['dist']} from 12a's")
    return rep


# ---------------------------------------------------------------------------
# phase 13: the analyzer catalogue at full width (create_analyzer's 32 names
# on VGG16 up to block5_conv3, the wrappers, imgword_batched, perturbation)
# ---------------------------------------------------------------------------
N_WORDS_13 = 20             # imgword_batched: words an image
CPU_WORDS_13 = 2            # ... of which the one image against the CPU explains 2
GATE_STEPS = 4              # IG's steps and SmoothGrad's samples in the one-image gate
PATTERN_BATCHES = 2         # generated batches of B_MAIN behind the patterns
REGION = 16                 # the perturbation's square region
VGG_BGR_MEAN = (103.939, 116.779, 123.68)
# deep_taylor.bounded's low and high: the preprocessed pixels' range
PIXEL_RANGE = (-max(VGG_BGR_MEAN), 255.0 - min(VGG_BGR_MEAN))
ANALYZER_PATHS = ("analyzers_f32", "analyzers_bf16")
# the names that reach K3: the post-ReLU convs' alpha1beta0 (12 convs, two
# launches each, 24 a call of B seeds) and alpha2beta1 (W+ and W-: 48)
K3_A1B0 = ("lrp.alpha_1_beta_0", "lrp.alpha_1_beta_0_IB", "lrp.z_plus", "lrp.z_plus_fast",
           "lrp.sequential_preset_a", "lrp.sequential_preset_a_flat", "deep_taylor",
           "deep_taylor.bounded")
K3_A2B1 = ("lrp.alpha_2_beta_1", "lrp.alpha_2_beta_1_IB", "lrp.alpha_beta",
           "lrp.sequential_preset_b", "lrp.sequential_preset_b_flat")
# registry aliases: the same function on the same inputs, one CPU reference
ALIASES = {"gradient.baseline": "gradient", "lrp.z_plus": "lrp.alpha_1_beta_0",
           "lrp.z_plus_fast": "lrp.alpha_1_beta_0", "lrp.sequential_preset_a": "lrp.alpha_1_beta_0",
           "lrp.alpha_beta": "lrp.alpha_2_beta_1", "lrp.sequential_preset_b": "lrp.alpha_2_beta_1",
           "lrp.epsilon": "lrp.z", "lrp.epsilon_IB": "lrp.z_IB", "deep_lift.wrapper": "deep_lift"}
# the one-image gate: the card's map may lie at most ANALYZER_RATIO times the
# CPU-f32 run's distance from a CPU-f64 run (both over the f64 map's scale;
# for the gradient methods by the 2-norm, as phase 8d: a near-tied ReLU or
# max pool that one f32 forward flips moves single values by % of the
# scale), or within the function's floor. Each floor is 2x the largest reading of
# either device over 3 images and 2 weight seeds (scripts/config_f64_spread.py
# --analyzers, H100 80GB HBM3 at 700 W; CHANGES.md lists the readings)
ANALYZER_RATIO = 4.0
GRAD_NAMES = ("gradient", "input_t_gradient", "deconvnet", "guided_backprop",
              "integrated_gradients", "smoothgrad")
ANALYZER_FLOOR = {             # largest reading: card, CPU f32
    "input": 0.0, "random": 0.0,                        # the input, the draws fed
    "gradient": 3.4e-2, "input_t_gradient": 3.4e-2,     # 1.03e-2, 1.70e-2 (2-norm)
    "deconvnet": 4.9e-3, "guided_backprop": 9.1e-4,     # 1.79e-3, 2.43e-3; 4.52e-4, 4.53e-4
    "integrated_gradients": 9.5e-3, "smoothgrad": 1.7e-2,   # 4.53e-3, 4.74e-3; 5.26e-3, 8.13e-3
    # the epsilon rule at 1e-7 divides by z + 1e-7 where z is near 0: an f32
    # run lies more than the map's scale from f64 on either device, so for
    # these two the gate holds the map finite and input-shaped only
    "lrp.z": 2.6, "lrp.z_IB": 7.2,                      # 1.30, 0.820; 3.19, 3.59
    "lrp.w_square": 4.4e-4, "lrp.flat": 4.3e-4,         # 4.10e-5, 2.16e-4; 4.14e-5, 2.11e-4
    "lrp.alpha_1_beta_0": 2e-4, "lrp.alpha_1_beta_0_IB": 2e-4,   # 5.90e-5, 9.85e-5; 6.38e-5, 9.89e-5
    "lrp.alpha_2_beta_1": 1.4e-4, "lrp.alpha_2_beta_1_IB": 1.4e-4,  # 5.07e-5, 6.54e-5; 5.02e-5, 6.59e-5
    "lrp.sequential_preset_a_flat": 1.7e-4,             # 5.90e-5, 8.10e-5
    "lrp.sequential_preset_b_flat": 1.4e-4,             # 4.87e-5, 6.61e-5
    "deep_taylor": 2.6e-3, "deep_taylor.bounded": 2.4e-3,   # 1.27e-3, 4.75e-4; 1.15e-3, 4.84e-4
    # DeepLIFT divides by the output difference, which cancels: ~50 % in f32
    "deep_lift": 1.1,                                   # 0.192, 0.515
    "pattern.net": 3.1e-3, "pattern.attribution": 7.1e-3,   # 1.51e-3, 7.14e-4; 1.68e-3, 3.52e-3
}


def analyzer_model(dev, seed=0):
    """VGG16 up to block5_conv3: the Keras init from ``seed``, biases drawn
    (N(0, 0.05^2): the init's are 0, which would make the _IB names the
    others)."""
    from lrp_imagecaptioning_torch.models.vgg import init_vgg_params
    from lrp_imagecaptioning_torch.weights import tree_to

    gen = torch.Generator().manual_seed(seed)
    params = init_vgg_params(gen)
    for p in params.values():
        p["bias"] = torch.randn(p["bias"].shape, generator=gen) * 0.05
    return tree_to(params, dev)


def analyzer_inputs(dev, n, seed, words=None):
    """``n`` images uniform over the preprocessed pixel range and their
    seeds at the tap, (n, 14, 14, 512), or (n, words, 14, 14, 512)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mean = torch.tensor(VGG_BGR_MEAN, device=dev)
    images = torch.rand(n, IMAGE, IMAGE, 3, generator=gen, device=dev) * 255.0 - mean
    g = IMAGE // 16                                   # the tap's grid
    shape = (n, g, g, 512) if words is None else (n, words, g, g, 512)
    return images, torch.randn(shape, generator=gen, device=dev)


def analyzer_kwargs(name, patterns, dev, noise=None):
    """``name``'s options: alpha2beta1 for lrp.alpha_beta, the pixel range
    for deep_taylor.bounded, the patterns, a generator on ``dev`` (or the
    draws ``noise``, and GATE_STEPS) for random, smoothgrad and IG."""
    if name == "lrp.alpha_beta":
        return dict(alpha=2.0, beta=1.0)
    if name == "deep_taylor.bounded":
        return dict(low=PIXEL_RANGE[0], high=PIXEL_RANGE[1])
    if name.startswith("pattern."):
        return dict(patterns=patterns)
    if name == "integrated_gradients" and noise is not None:
        return dict(steps=GATE_STEPS)
    if name in ("random", "smoothgrad"):
        kw = dict(generator=torch.Generator(device=dev).manual_seed(21)) if noise is None \
            else dict(noise=noise.to(dev))
        if name == "smoothgrad" and noise is not None:
            kw["n"] = GATE_STEPS
        return kw
    return {}


def gate_noise(name):
    """The standard normal draws of the one-image gate (CPU generator),
    shared by the card and the CPU runs; None for a name without draws."""
    if name not in ("random", "smoothgrad", "integrated_gradients"):
        return None
    gen = torch.Generator().manual_seed(22)
    shape = (1, IMAGE, IMAGE, 3) if name == "random" else (1, GATE_STEPS, IMAGE, IMAGE, 3)
    return torch.randn(shape, generator=gen)


def analyzer_gate(name, params, image, seed, patterns, dev, card_map=None, cache=None):
    """One image (1, H, W, 3) and its seed: the card's map (``card_map``, a
    row of the batch run, else a run here), the CPU's in f32 and in f64 (of
    the name an alias stands for, kept in ``cache``) -> (card's, CPU-f32's
    distance from f64 over its scale, CPU seconds)."""
    from lrp_imagecaptioning_torch.explain.analyzers import create_analyzer
    from lrp_imagecaptioning_torch.weights import tree_to

    noise = gate_noise(name)
    canon = ALIASES.get(name, name)
    cache = {} if cache is None else cache
    t0 = time.perf_counter()
    with torch.no_grad():
        if card_map is None:
            card_map = create_analyzer(name, params, **analyzer_kwargs(name, patterns, dev,
                                                                       noise))(image, seed)
        if canon not in cache:
            cache[canon] = {}
            for dtype in (torch.float32, torch.float64):
                p = tree_to(tree_to(params, "cpu"), dtype=dtype)
                pats = None if patterns is None else tree_to(tree_to(patterns, "cpu"),
                                                             dtype=dtype)
                kw = analyzer_kwargs(canon, pats, "cpu",
                                     None if noise is None else noise.to(dtype))
                cache[canon][dtype] = create_analyzer(canon, p, **kw)(
                    image.cpu().to(dtype), seed.cpu().to(dtype))
    maps = cache[canon]
    ref = maps[torch.float64]
    dist = map_dist_l2 if canon in GRAD_NAMES else map_dist
    card, cpu = dist(card_map.detach().cpu().double(), ref), dist(maps[torch.float32].double(), ref)
    return card, cpu, time.perf_counter() - t0


def map_dist(got, ref):
    """The largest distance over the reference's largest |value|."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def map_dist_l2(got, ref):
    """The distance's 2-norm over the reference's (phase 8d's measure)."""
    return float((got - ref).norm()) / max(float(ref.norm()), 1e-30)


def analyzer_summary(dev, failures, detail):
    """K3 and K4 at imgword_batched's shapes (per image its N_WORDS_13 words
    as a launch's batch, B_MAIN images): K3's are phase 2's f32 rows where
    phase 2 ran."""
    import copy

    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for path, name, check, dims in (
            ("analyzers_f32", "conv3x3_fused", check_conv3x3_fused, (None, B_MAIN, N_WORDS_13)),
            ("analyzers_bf16", "lrp_a1b0_fused", check_lrp_a1b0_fused,
             (torch.bfloat16, B_MAIN, N_WORDS_13))):
        rows = [r for r in detail.get(name, ()) if r["path"] == "f32"]
        rows = copy.deepcopy(rows) if rows and (B_MAIN, N_WORDS_13) == PATHS["f32"][1:] \
            and name == "conv3x3_fused" else check(gen, dev, path, dims)
        log(f"  {path}: {name} at imgword_batched's shapes, {B_MAIN} images x {N_WORDS_13} words")
        out[path] = {name: summarize_rows(name, path, B_MAIN, rows, failures)}
        detail.setdefault(name, []).extend(rows)
    return out


def phase_analyzers(dev, failures, detail):
    """13: the 32 names at batch B_MAIN, the wrappers, imgword_batched in
    three modes, perturbation analysis, and K3 / K4 timed at imgword's
    shapes. Returns (launches, kernel summaries, report) of the paths
    analyzers_f32 and analyzers_bf16."""
    from lrp_imagecaptioning_torch.explain import cnn_lrp
    from lrp_imagecaptioning_torch.explain.analyzers import (analyzer_names, create_analyzer,
                                                            gaussian_smoother, path_integrator)
    from lrp_imagecaptioning_torch.explain.patterns import compute_vgg_patterns
    from lrp_imagecaptioning_torch.explain.perturbation import (Perturbation,
                                                               PerturbationAnalysis)
    from lrp_imagecaptioning_torch.models.vgg import vgg_apply

    rep, launches = {"names": {}}, {}
    params = analyzer_model(dev)
    images, seeds = analyzer_inputs(dev, B_MAIN, 31)
    t0 = time.perf_counter()
    pattern_images = [analyzer_inputs(dev, B_MAIN, 40 + i)[0] for i in range(PATTERN_BATCHES)]
    patterns, pat_ms = timed(compute_vgg_patterns, params, pattern_images, "relu")
    rep["patterns_ms"] = pat_ms
    log(f"  patterns ('relu') over {PATTERN_BATCHES} batches of {B_MAIN}: {pat_ms:.1f} ms")
    cache = {}
    for name in analyzer_names():
        analyze = create_analyzer(name, params, **analyzer_kwargs(name, patterns, dev))
        with torch.no_grad():
            analyze(images, seeds)                                   # warm
            out, ms, counted = counted_run(analyze, images, seeds)
        want = dict.fromkeys(counted, 0)
        want["conv3x3_fused"] = 24 if name in K3_A1B0 else 48 if name in K3_A2B1 else 0
        r = dict(ms=ms, img_per_s=B_MAIN / ms * 1e3, launches=counted, expected=want)
        if counted != want:
            failures.append(f"13 {name}: launches {counted}, {want} derived")
        if tuple(out.shape) != tuple(images.shape) or not bool(torch.isfinite(out).all()):
            failures.append(f"13 {name}: map {tuple(out.shape)}, finite "
                            f"{bool(torch.isfinite(out).all())}")
        # the one-image gate on image 0 (IG and SmoothGrad at GATE_STEPS, run apart)
        row = None if gate_noise(name) is not None else out[:1]
        canon = ALIASES.get(name, name)
        card, cpu, cpu_s = analyzer_gate(name, params, images[:1], seeds[:1], patterns, dev, row,
                                         cache)
        r.update(card_vs_f64=card, cpu_vs_f64=cpu, cpu_s=cpu_s, floor=ANALYZER_FLOOR[canon])
        if card > max(ANALYZER_RATIO * cpu, ANALYZER_FLOOR[canon]):
            failures.append(f"13 {name}: the card's map lies {card:.3e} from CPU f64, CPU f32 "
                            f"{cpu:.3e}, floor {ANALYZER_FLOOR[canon]:.1e}")
        rep["names"][name] = r
        log(f"  13 {name:30s} batch {B_MAIN}: {ms:8.2f} ms = {r['img_per_s']:8.2f} img/s; K3 "
            f"{counted['conv3x3_fused']:2d} launches; one image vs CPU f64: card {card:.3e}, "
            f"CPU f32 {cpu:.3e} ({cpu_s:.1f} s)")
        del out
    del cache
    rep["names_s"] = time.perf_counter() - t0

    # the wrappers over PresetA at n = 4 (K3 24 launches a pass)
    preset_a = create_analyzer("lrp.sequential_preset_a", params)
    gen = torch.Generator(device=dev).manual_seed(24)
    with torch.no_grad():
        for label, fn, passes in (
                ("gaussian_smoother", lambda: gaussian_smoother(preset_a, images, seeds, gen,
                                                                noise_scale=16.0, n=4), 4),
                ("path_integrator", lambda: path_integrator(preset_a, images, seeds, steps=4), 4)):
            fn()
            out, ms, counted = counted_run(fn)
            rep[label] = dict(ms=ms, img_per_s=B_MAIN / ms * 1e3, launches=counted)
            log(f"  13 {label} over lrp.sequential_preset_a, n = 4, batch {B_MAIN}: {ms:.1f} ms "
                f"= {rep[label]['img_per_s']:.2f} img/s; launches {counted}")
            if counted["conv3x3_fused"] != 24 * passes or not bool(torch.isfinite(out).all()):
                failures.append(f"13 {label}: launches {counted}, finite "
                                f"{bool(torch.isfinite(out).all())}")
        # their arithmetic: zero noise gives the analyzer's map, and the
        # path integral of the gradient is integrated_gradients
        base = preset_a(images, seeds)
        still = gaussian_smoother(preset_a, images, seeds, gen, noise_scale=0.0, n=2)
        gradient = create_analyzer("gradient", params)
        ig = create_analyzer("integrated_gradients", params, steps=GATE_STEPS)(images, seeds)
        via = path_integrator(gradient, images, seeds, steps=GATE_STEPS)
    rep["wrapper_identities"] = dict(smoother=rel_err(still, base)[1], path=rel_err(via, ig)[1])
    log(f"  13 wrappers: zero-noise smoother vs the map {rep['wrapper_identities']['smoother']:.2e}"
        f", path_integrator(gradient) vs integrated_gradients "
        f"{rep['wrapper_identities']['path']:.2e} of scale")
    if max(rep["wrapper_identities"].values()) > 1e-5:
        failures.append(f"13 wrappers: {rep['wrapper_identities']}")
    del base, still, ig, via

    # imgword_batched: f32 on K3, bf16 storage on K4, bf16 compute on neither
    images_w, seeds_w = analyzer_inputs(dev, B_MAIN, 32, words=N_WORDS_13)
    maps = {}
    for mode, kw, want in (("f32", {}, {"conv3x3_fused": 2 * CONVS * B_MAIN}),
                           ("bf16_storage", {"storage_dtype": torch.bfloat16},
                            {"lrp_a1b0_fused": CONVS * B_MAIN}),
                           ("bf16_compute", {"compute_dtype": torch.bfloat16}, {})):
        fn = lambda: cnn_lrp.vgg_lrp_preset_a_imgword_batched(params, images_w, seeds_w, **kw)  # noqa: E731,B023
        with torch.no_grad():
            fn()
            out, ms, counted = counted_run(fn)
        want = {k: want.get(k, 0) for k in counted}
        rep[f"imgword_{mode}"] = dict(ms=ms, img_per_s=B_MAIN / ms * 1e3,
                                      maps_per_s=B_MAIN * N_WORDS_13 / ms * 1e3,
                                      launches=counted, expected=want)
        log(f"  13 imgword_batched {mode}, {B_MAIN} images x {N_WORDS_13} words: {ms:.1f} ms = "
            f"{rep[f'imgword_{mode}']['img_per_s']:.2f} img/s; launches {counted}")
        if counted != want:
            failures.append(f"13 imgword_batched {mode}: launches {counted}, {want} derived")
        if mode == "f32":
            launches["analyzers_f32"] = counted
        elif mode == "bf16_storage":
            launches["analyzers_bf16"] = counted
        if tuple(out.shape) != (B_MAIN, N_WORDS_13, IMAGE, IMAGE, 3) \
                or not bool(torch.isfinite(out).all()):
            failures.append(f"13 imgword_batched {mode}: {tuple(out.shape)}")
        maps[mode] = out[0, :CPU_WORDS_13].cpu()
        del out
    # the first image's first words against the CPU: f32 as the K3 names,
    # bf16 within BF16_CPU_RATIO of the CPU-bf16 run's distance from CPU f32
    from lrp_imagecaptioning_torch.weights import tree_to

    x_c, s_c = images_w[:1].cpu(), seeds_w[:1, :CPU_WORDS_13].cpu()
    p_c = tree_to(params, "cpu")
    with torch.no_grad():
        cpu = {mode: cnn_lrp.vgg_lrp_preset_a_imgword_batched(p_c, x_c, s_c, **kw)[0]
               for mode, kw in (("f32", {}), ("bf16_storage", {"storage_dtype": torch.bfloat16}),
                                ("bf16_compute", {"compute_dtype": torch.bfloat16}))}
        f64 = cnn_lrp.vgg_lrp_preset_a_imgword_batched(
            tree_to(p_c, dtype=torch.float64), x_c.double(), s_c.double())[0]
    scale = float(f64.abs().max())
    card_d, cpu_d = (float((m.double() - f64).abs().max()) / scale for m in (maps["f32"],
                                                                              cpu["f32"]))
    floor = ANALYZER_FLOOR["lrp.alpha_1_beta_0"]
    rep["imgword_cpu"] = {"f32": dict(card_vs_f64=card_d, cpu_vs_f64=cpu_d)}
    if card_d > max(ANALYZER_RATIO * cpu_d, floor):
        failures.append(f"13 imgword_batched f32: card {card_d:.3e} from f64, CPU {cpu_d:.3e}")
    for mode in ("bf16_storage", "bf16_compute"):
        card_b = rel_err(maps[mode], cpu["f32"])[1]
        cpu_b = rel_err(cpu[mode], cpu["f32"])[1]
        rep["imgword_cpu"][mode] = dict(card_vs_cpu_f32=card_b, cpu_vs_cpu_f32=cpu_b)
        if card_b > BF16_CPU_RATIO * cpu_b:
            failures.append(f"13 imgword_batched {mode}: card {card_b:.3e} from CPU f32, CPU "
                            f"bf16 {cpu_b:.3e}")
    log(f"  13 imgword_batched, image 0's first {CPU_WORDS_13} words vs the CPU: "
        f"{rep['imgword_cpu']}")

    # perturbation analysis over PresetA maps: MoRF, zeros, 16x16 regions, 3 steps;
    # the score is the tapped features' sum against the seed, an image's mean
    seeds_np = seeds.cpu().numpy()

    def analyze_fn(x):
        with torch.no_grad():
            return preset_a(torch.from_numpy(x).to(dev), seeds).cpu().numpy()

    def score_fn(x, y):
        with torch.no_grad():
            feats = vgg_apply(params, torch.from_numpy(x).to(dev))
            return float((feats * torch.from_numpy(y).to(dev)).sum()) / len(x)

    batch = (images.cpu().numpy(), seeds_np)
    pa = PerturbationAnalysis(analyze_fn, score_fn, [batch],
                              Perturbation("zeros", region_shape=(REGION, REGION)), steps=3)
    scores, ms = timed(pa.compute_perturbation_analysis)
    direct = score_fn(*batch)
    rep["perturbation"] = dict(scores=scores, ms=ms, unperturbed=direct)
    log(f"  13 PerturbationAnalysis (zeros, {REGION}x{REGION}, 3 steps) over PresetA maps of "
        f"{B_MAIN} images: {ms:.1f} ms; scores {scores}")
    if len(scores) != 4 or not all(math.isfinite(v) for v in scores) or scores[0] != direct:
        failures.append(f"13 perturbation: scores {scores}, unperturbed {direct}")
    return launches, analyzer_summary(dev, failures, detail), rep


# ---------------------------------------------------------------------------
# phase 14: scale-out (parallel/) at full width on a 2-slot mesh whose slots
# both sit on the one card, and real process groups on it
# ---------------------------------------------------------------------------
SLOTS = 2                   # the mesh's data slots, both on cuda:0
B_MESH_SERVE = B_MAIN       # 14d's CaptionService batch: 4 a slot
N_EXPORTED = 2 * B_MAIN     # 14e: two chunks of the exported batch, one a slot
# the paths of phase 14 (each driven with the counts at 0 just before it):
# name -> (a path whose kernel shapes one slot's share takes, (storage,
# rows a slot, words), launches a slot are counted on how many slots)
MESH_PATHS = {
    "mesh_train": ("train", (None, B_TRAIN // SLOTS, T_TRAIN), SLOTS),
    "mesh_finetune": ("finetune", (None, B_TRAIN // SLOTS, T_TRAIN), SLOTS),
    "shard_words_f32": ("serve_f32", (None, 1, T // SLOTS), SLOTS),
    "shard_words_bf16": ("serve_bf16", (torch.bfloat16, 1, T // SLOTS), SLOTS),
    "mesh_bf16": ("serve_bf16", (torch.bfloat16, B_BF16 // SLOTS, T), SLOTS),
    "mesh_serve": ("serve_f32", (None, B_MESH_SERVE // SLOTS, T), SLOTS),
    "mesh_exported": ("serve_f32", (None, B_MAIN, T), N_EXPORTED // B_MAIN),
    "multihost_train": ("train", (None, B_TRAIN // SLOTS, T_TRAIN), SLOTS),
    "multihost_nccl": ("train", (None, B_TRAIN, T_TRAIN), 1),
    "multihost_nccl_finetune": ("finetune", (None, B_TRAIN, T_TRAIN), 1),
    "vocab_train": ("train", (None, B_TRAIN, T_TRAIN), 1),
}
# the paths explaining given captions: K2 in the cached forward only
GIVEN_TOKENS = ("shard_words_f32", "shard_words_bf16", "mesh_bf16")
# phase 6c's K-step calls and 14f's K-step call of the 1-rank NCCL group
# (the one-device call, captured): name -> (the path whose kernel shapes each step takes, (storage,
# rows, words), steps a call)
MESH_PATHS.update({
    "multi_train": ("train", (None, B_TRAIN, T_TRAIN), K_TRAIN),
    "multi_finetune": ("finetune", (None, B_TRAIN, T_TRAIN), K_FINETUNE),
    "multi_nccl": ("train", (None, B_TRAIN, T_TRAIN), K_TRAIN),
})
PATH_KERNELS.update({
    "multi_train": ("lstm_gates",), "multi_nccl": ("lstm_gates",),
    "multi_finetune": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
    "mesh_train": ("lstm_gates",), "multihost_train": ("lstm_gates",),
    "multihost_nccl": ("lstm_gates",), "vocab_train": ("lstm_gates",),
    "mesh_finetune": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
    "multihost_nccl_finetune": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
    "shard_words_f32": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
    "shard_words_bf16": ("lrp_linear", "lstm_gates", "lrp_a1b0_fused"),
    "mesh_bf16": ("lrp_linear", "lstm_gates", "lrp_a1b0_fused"),
    "mesh_serve": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
    "mesh_exported": ("lrp_linear", "lstm_gates", "conv3x3_fused"),
})
# 14a/14b: the sharded gradient (before the clip) against the one-device
# step's on the same batch and dropout masks, by each leaf's 2-norm of the
# distance over its own (the largest |distance| over the leaf's scale is
# logged beside); the loss relative. Each slot's forward and backward run
# at batch 16, the one device's at 32: cuDNN and cuBLAS sum in another
# order at another batch, and a ReLU or max-pool near-tie that flips moves
# a lower VGG leaf's gradient by up to 1.5e-3 of its norm from f64 (phase
# 9b's note, scripts/train_grad_accuracy.py), so two such f32 runs may lie
# twice that apart. An H100 80GB HBM3 at 700 W read 2.115e-3 (train) and
# 2.153e-3 (fine-tune) by the 2-norm, 1.14e-3 and 8.1e-4 by the largest
# |distance| of a leaf over its scale: 2x the largest reading
TOL_MESH_GRAD = 4.5e-3
TOL_MESH_LOSS = 1e-5
# after one Adam step (g / (|g| + eps) ~ sign(g) for |g| >> eps): the share
# of params whose update differs by over lr / 2 from the one-device step's,
# an element whose gradient is near 0 taking the other sign under the other
# order of the sums. The H100 read 9.6e-7 (train), 3.3e-7 (fine-tune and
# 14f): 24 and 8 of 25M params
MESH_FLIP_SHARE = 1e-5
# 14c/14d: the decoder LRP's outputs (feat_relevance, word_relevances) of a
# mesh run against the one-device run. A slot runs the cached forward and
# K1 at its share of the rows, where cuBLAS sums in another order, and the
# divides by z +- 1e-7 amplify that: f32 rounding alone puts feat_relevance
# 1.3e-4 to 5.3e-3 of its scale from f64 at full width (phase 8's note), so
# two f32 runs may lie twice that apart. An H100 80GB HBM3 at 700 W read
# 5.86e-3 (analyze_many at 28 a slot against 56) and 2.2e-3 (CaptionService
# at 4 a slot against 8): 2x the largest reading
TOL_MESH_LRP = 1.2e-2


def host_gib() -> str:
    """This process's resident host memory now (where /proc says) and at its
    peak, and its children's peak, GiB."""
    import resource

    now = "?"
    try:
        with open("/proc/self/status") as f:
            rss = [line.split()[1] for line in f if line.startswith("VmRSS")]
        now = f"{int(rss[0]) / 2**20:.2f}" if rss else now
    except OSError:
        pass
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    children = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20
    return f"host RSS {now} GiB, peak {peak:.2f}, children's peak {children:.2f}"


class GradRecorder:
    """An optimizer that keeps the gradient it is handed and moves nothing."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params=None):
        from lrp_imagecaptioning_torch.weights import tree_map

        self.grads = grads
        return tree_map(torch.zeros_like, grads), state


def grad_dist(got, ref):
    """(the largest 2-norm of a gradient leaf's distance from the reference's
    over the reference leaf's, the largest |distance| of a leaf over its
    scale); a leaf's norm and scale floored at 1e-3 of the largest leaf's
    (a leaf that is 0 in exact arithmetic holds only rounding)."""
    from lrp_imagecaptioning_torch.weights import tree_leaves

    pairs = list(zip(tree_leaves(got), tree_leaves(ref)))
    norm_floor = 1e-3 * max(float(r.norm()) for _, r in pairs)
    floor = 1e-3 * max(float(r.abs().max()) for _, r in pairs)
    return (max(float((g - r).norm()) / max(float(r.norm()), norm_floor, 1e-30)
                for g, r in pairs),
            max(float((g - r).abs().max()) / max(float(r.abs().max()), floor, 1e-30)
                for g, r in pairs))


def adam_apart(opt, params, grads_a, grads_b):
    """One Adam step from ``params`` on each gradient: the share of params
    whose update differs by over lr / 2, and the largest difference."""
    from lrp_imagecaptioning_torch.weights import tree_leaves

    state = opt.init(params)
    a, b = (tree_leaves(opt.update(g, state, params)[0]) for g in (grads_a, grads_b))
    n = sum(x.numel() for x in a)
    apart = sum(int(((x - y).abs() > opt.learning_rate / 2).sum()) for x, y in zip(a, b))
    return apart / n, max(float((x - y).abs().max()) for x, y in zip(a, b))


def mesh_summary(dev, path, failures, detail):
    """``path``'s kernels at one slot's shapes (MESH_PATHS), counted on each
    slot: K1 and K2 timed at those shapes, K3 and K4 (per image its words
    as a launch's batch) from phase 2's rows of the same words where they
    exist."""
    import copy

    base, dims, slots = MESH_PATHS[path]
    gen = torch.Generator(device=dev).manual_seed(24)
    reuse = {("conv3x3_fused", T): "f32", ("conv3x3_fused", T_TRAIN): "finetune",
             ("lrp_a1b0_fused", T): "bf16"}
    out = {}
    for name in PATH_KERNELS[path]:
        src = reuse.get((name, dims[2]))
        rows = [r for r in detail.get(name, ()) if r["path"] == src]
        if rows:
            per_image = PATHS[src][1]
            rows = [dict(copy.deepcopy(r), calls=r["calls"] // per_image * dims[1]) for r in rows]
        else:
            rows = KERNEL_META[name][2](gen, dev, base, dims)
        if name == "lstm_gates" and path in GIVEN_TOKENS:   # no beam search
            rows = [r for r in rows if r["shape"] == "cached_forward"]
        for r in rows:
            r["calls"] *= slots
        log(f"  {path}: {name} at one slot's shapes {dims[1:]}, x{slots}")
        out[name] = summarize_rows(name, path, dims[1] * slots, rows, failures)
        detail.setdefault(name, []).extend(rows)
    return out


def mesh_held(got, ref, label, failures, storage_dtype=None, exact_tol=None):
    """Explanations of a sharded path against the one-device run's: the
    words equal, the decoder LRP's outputs within TOL_MESH_LRP, the heatmaps
    within TOL_CONSISTENT (f32) or the bf16 rule's tolerance, the rest
    within TOL_CONSISTENT (phase 8's entry points' bound across batch
    sizes); ``exact_tol`` holds every array to it instead."""
    tol = dict.fromkeys(EXPLANATION_FIELDS, TOL_CONSISTENT if exact_tol is None else exact_tol)
    if exact_tol is None:
        tol.update(feat_relevance=TOL_MESH_LRP, word_relevances=TOL_MESH_LRP,
                   relevance_maps=TOL_CONSISTENT if storage_dtype is None else TOL_BF16_KERNEL)
    dist = explanation_dist(got, ref)
    bad = {f: d for f, d in dist.items() if d > tol[f]}
    if bad or len(got) != len(ref):
        failures.append(f"{label}: against the one-device run {bad} (words differ: inf)")
    return dist


def accuracy_batch(cap, params, batch, seed, dev):
    """``batch`` relabelled so that 14a/14b's accuracy check compares a value
    that is not 0 over batch halves (14a's and 14b's data slots) whose
    accuracies differ: the first half's captions cut to T_TRAIN // 2
    steps; at each valid step of a row of the first half or an even row of
    the second, the one-device forward's
    argmax (dropout from ``seed``) where it leads the runner-up by more than
    1e-2 of the largest |logit| (far above the f32 rounding of another
    batch split), at every other step its argmin. Returns (batch, the
    accuracy these labels give, the mean of the halves' accuracies)."""
    images, captions_in, y = batch
    with torch.no_grad():
        logits = cap.forward_train(params, images, captions_in,
                                   torch.Generator(device=dev).manual_seed(seed))[:, :-1]
    per = B_TRAIN // SLOTS
    y = y.clone()
    y[:per, T_TRAIN // 2:] = 0
    top = logits.topk(2, -1)
    rows = torch.arange(B_TRAIN, device=dev)
    hit = ((rows < per) | (rows % 2 == 0))[:, None] & (
        top.values[..., 0] - top.values[..., 1] > 1e-2 * logits.abs().max())
    valid = y[:, :-1].sum(-1) > 0
    label = torch.where(hit, top.indices[..., 0], logits.argmin(-1))
    y[:, :-1] = F.one_hot(label, VOCAB).float() * valid[..., None]
    correct = hit & valid
    ratios = [float(correct[i:i + per].sum() / valid[i:i + per].sum())
              for i in range(0, B_TRAIN, per)]
    return (images, captions_in, y), float(correct.sum() / valid.sum()), sum(ratios) / SLOTS


def mesh_step(label, make_single, make_sharded, params, batch, seed, opt, want, failures, dev,
              accuracy, sharded_params=None):
    """14a/14b: one step on one device and one sharded over the mesh, each
    with a gradient recorder, the same batch and one generator seed (the
    same dropout masks): loss, accuracy, the gradients and the params one
    Adam step would give; the sharded step counted and both timed.
    ``accuracy``: (the accuracy the batch's labels give, the mean of the
    batch halves' accuracies), from ``accuracy_batch``. ``sharded_params``: the
    params as the sharded step takes them (split on the vocabulary), its
    gradients joined again to compare."""
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.parallel import gather_params

    one, shard = GradRecorder(), GradRecorder()
    single, sharded = make_single(one), make_sharded(shard)
    gen = lambda: torch.Generator(device=dev).manual_seed(seed)   # noqa: E731
    mesh_params = params if sharded_params is None else sharded_params
    single(params, None, *batch, gen())       # both warm (cuDNN's choice at each batch)
    sharded(mesh_params, None, *batch, gen())
    (_, _, m1), ms1 = timed(single, params, None, *batch, gen())
    kernels.reset_launches()
    (_, _, m2), ms2 = timed(sharded, mesh_params, None, *batch, gen())
    launches = counts()
    grads = shard.grads if sharded_params is None else gather_params(shard.grads, dev)
    dist, dist_max = grad_dist(grads, one.grads)
    share, largest = adam_apart(opt, params, grads, one.grads)
    loss_rel = abs(float(m2["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    acc_want, acc_slot_mean = accuracy
    rep = dict(ms_one_device=ms1, ms_mesh=ms2, loss=[float(m1["loss"]), float(m2["loss"])],
               loss_rel=loss_rel, accuracy=[float(m1["accuracy"]), float(m2["accuracy"])],
               accuracy_of_labels=acc_want, accuracy_slot_mean=acc_slot_mean,
               grad_dist=dist, grad_dist_max=dist_max, adam_apart_share=share,
               adam_largest=largest, launches=launches, expected=want)
    log(f"  {label}: one device {ms1:.1f} ms, the mesh on the card {ms2:.1f} ms; loss "
        f"{rep['loss']} (rel {loss_rel:.3e}), accuracy {rep['accuracy']} (the labels give "
        f"{acc_want}, the mean of the batch halves' {acc_slot_mean}); gradient {dist:.3e} "
        f"of its norm (largest |distance| {dist_max:.3e} of scale); one Adam step: "
        f"{share:.3e} of params apart by > lr/2 (largest {largest:.3e}); launches {launches}")
    if launches != want:
        failures.append(f"{label}: launches {launches}, {want} derived")
    if loss_rel > TOL_MESH_LOSS or rep["accuracy"][0] != rep["accuracy"][1]:
        failures.append(f"{label}: loss {rep['loss']} / accuracy {rep['accuracy']}")
    if (not acc_want > 0 or abs(rep["accuracy"][0] - acc_want) > 1e-6
            or abs(acc_slot_mean - acc_want) < 1e-3):
        failures.append(f"{label}: accuracy {rep['accuracy']}, the labels give {acc_want}, the "
                        f"mean of the batch halves' {acc_slot_mean}")
    if dist > TOL_MESH_GRAD or share > MESH_FLIP_SHARE:
        failures.append(f"{label}: gradient {dist:.3e} of scale, Adam step apart {share:.3e}")
    return rep


def parallel_worker():
    """``tests/torch_parallel_worker.py``: the launcher (``torchrun``) and
    the rank of 14f."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_parallel_worker

    return torch_parallel_worker


def start_group(work, name, n, cards, backend="nccl", steps="train,finetune"):
    """A group of ``n`` ranks, one ``torchrun`` agent on this host, the
    first ``cards`` cards visible: each rank builds a Trainer on its
    default mesh (gloo: on cuda:0, shared) and runs ``steps`` at full
    width on its rows of one seeded global batch of 32, each against the
    one-device step on rank 0. -> (output prefix, the agent)."""
    prefix = os.path.join(work, f"{name}_")
    return prefix, parallel_worker().launch(
        n, ["--rank", prefix, "--size", "full", "--backend", backend, "--steps", steps],
        cards=cards, cwd=work)


def read_group(group, n, label):
    """The ranks' results of ``start_group``; raises where the agent failed."""
    worker = parallel_worker()
    prefix, procs = group
    (text, rc), = worker.finish(procs)
    if rc != 0:
        log(text[-4000:])
        raise RuntimeError(f"14f {label}: torchrun rc {rc}")
    return [worker.load_rank(f"{prefix}{r}.npz") for r in range(n)]


def ranks_held(label, ranks, key, lr, want, failures):
    """Step ``key`` (its index in the ranks' steps) of a group against the
    one-device step on rank 0 (``torch_parallel_worker.against``): the loss,
    the gradient, the params after the step (the share apart by over lr / 2:
    Adam's flips; the largest distance), the ranks' params bit for bit, each
    rank's launches against ``want``. Returns the report."""
    r0 = ranks[0]
    equal = len({r[f"{key}_digest"] for r in ranks}) == 1
    rep = dict(loss=[r[f"{key}_loss"] for r in ranks], ms=[r[f"{key}_ms"] for r in ranks],
               accuracy=[r[f"{key}_acc"] for r in ranks],
               launches=[r[f"{key}_launches"] for r in ranks], ranks_equal=equal,
               expected_a_rank=want, **{k: r0[f"{key}_{k}"] for k in (
                   "ref_loss", "loss_rel", "grad_dist", "leaf_dist", "apart", "largest")})
    log(f"  14f {label} {r0['steps'][key]}: losses {rep['loss']} (one device "
        f"{rep['ref_loss']:.6f}, rel {rep['loss_rel']:.3e}), ms "
        f"{[round(v, 1) for v in rep['ms']]}, gradient {rep['grad_dist']:.3e} of its norm "
        f"(largest |distance| {rep['leaf_dist']:.3e} of scale), {rep['apart']:.3e} of params "
        f"apart by > lr/2 (largest {rep['largest']:.3e}); the ranks' params bit for bit "
        f"{equal}; launches {rep['launches']}")
    if any(v != want for v in rep["launches"]):
        failures.append(f"14f {label} {key}: launches {rep['launches']}, {want} derived a rank")
    if (rep["loss_rel"] > TOL_MESH_LOSS or rep["grad_dist"] > TOL_MESH_GRAD
            or rep["apart"] > MESH_FLIP_SHARE or rep["largest"] > 2.5 * lr or not equal):
        failures.append(f"14f {label} {key} against one device: loss rel {rep['loss_rel']:.3e}, "
                        f"gradient {rep['grad_dist']:.3e}, params apart {rep['apart']:.3e} "
                        f"(largest {rep['largest']:.3e}), ranks equal {equal}")
    return rep


def phase_multihost(dev, failures, work):
    """14f: groups started by ``torchrun`` (its agent serves the store),
    each rank building a multihost Trainer and running its steps at full
    width on its rows of one seeded global batch of 32, held to the
    one-device step on rank 0 (loss, gradient, Adam's flips, the ranks'
    params bit for bit) and each rank's launches to one step's at its rows.
    Started together: a 1-rank NCCL group on its default mesh (it must be
    ``[[cuda:0]]``), a Trainer step and a sharded fine-tune step; a 2-rank
    gloo group on cuda:0 (two ranks share the card: NCCL refuses that),
    a Trainer step; ``torchrun --nproc-per-node 2`` under NCCL on the one
    card, which must raise the split's ValueError in both ranks before the
    group is joined. With N >= 2 cards, then NCCL groups of 2 and 4 ranks
    (as the cards allow), one a card, both steps. Returns (launches by
    path, report)."""
    from lrp_imagecaptioning_torch.config import FlickrConfig

    worker = parallel_worker()
    cfg = FlickrConfig()
    lr = cfg.learning_rate
    want = {"train": expected_launches("train", cfg),
            "finetune": expected_launches("finetune", cfg)}
    split = start_group(work, "split", 2, 1)
    nccl_group = start_group(work, "nccl1", 1, 1, steps="train,finetune,multi")
    gloo_group = start_group(work, "gloo2", 2, 1, backend="gloo", steps="train")
    (split_text, split_rc), = worker.finish(split[1])
    (nccl,), gloo = read_group(nccl_group, 1, "1-rank NCCL"), read_group(gloo_group, 2, "gloo")
    split_error = "1 visible cards do not split into LOCAL_WORLD_SIZE=2 equal blocks"
    refused = [worker.load_rank(f"{split[0]}{r}.npz") if os.path.exists(f"{split[0]}{r}.npz")
               else {} for r in range(2)]
    rep = dict(nccl_mesh=nccl["mesh"], split_rc=split_rc, split_refused=split_rc == 0 and all(
        r.get("error") == split_error and not r["initialized"] for r in refused))
    log(f"  14f 1-rank NCCL on its default mesh {nccl['mesh']}; torchrun --nproc-per-node 2 "
        f"on one card: rc {split_rc}, both ranks refused with the split's ValueError before "
        f"joining {rep['split_refused']}")
    if nccl["mesh"] != [["cuda:0"]]:
        failures.append(f"14f: the 1-rank NCCL group's default mesh is {nccl['mesh']}")
    if not rep["split_refused"]:
        failures.append(f"14f: two ranks on one card were not refused with the split's "
                        f"ValueError (rc {split_rc}): {refused} {split_text[-2000:]}")
    rep["nccl_1_rank"] = {key: ranks_held("1-rank NCCL", [nccl], k, lr, want[key], failures)
                          for k, key in enumerate(want)}
    # the Trainer's K-step call: on a group of one rank the one-device call
    # (train.step.one_device_mesh), its step captured and replayed K times,
    # against K chained one-device steps
    rep["nccl_1_rank"]["multi"] = ranks_held(
        f"1-rank NCCL, K = {parallel_worker().MULTI_K} steps a call", [nccl], 2, lr,
        {k: parallel_worker().MULTI_K * v for k, v in want["train"].items()}, failures)
    rep["nccl_1_rank"]["multi"].update(captures=nccl["2_captures"], losses=nccl["2_losses"].tolist(),
                                       ref_losses=nccl["2_ref_losses"].tolist())
    if nccl["2_captures"] != 1:
        failures.append(f"14f: the 1-rank NCCL group's K-step call made {nccl['2_captures']} "
                        "captures (-1: it chained the sharded steps), 1 expected: a group "
                        "of one rank runs the one-device call")
    rep["gloo_2_ranks"] = ranks_held("2-rank gloo (the ranks share the card)", gloo, 0, lr,
                                     expected_launches("train", FlickrConfig(batch_size=16)),
                                     failures)
    launches = {"multihost_train": {k: sum(r["0_launches"][k] for r in gloo)
                                    for k in want["train"]},
                "multihost_nccl": nccl["0_launches"],
                "multihost_nccl_finetune": nccl["1_launches"],
                "multi_nccl": nccl["2_launches"]}
    cards = torch.cuda.device_count()
    groups = [n for n in (2, 4) if n <= cards]
    if not groups:
        log(f"  14f: {cards} card visible: the NCCL groups of one rank a card did not run")
    for n in groups:
        ranks = read_group(start_group(work, f"nccl{n}", n, n), n, f"{n}-rank NCCL")
        meshes = [r["mesh"] for r in ranks]
        log(f"  14f {n}-rank NCCL, one rank a card: meshes {meshes}")
        if meshes != [[[f"cuda:{r}"]] for r in range(n)]:
            failures.append(f"14f {n}-rank NCCL: meshes {meshes}")
        rows = B_TRAIN // n
        for k, (key, suffix) in enumerate((("train", ""), ("finetune", "_finetune"))):
            path = f"nccl_{n}_ranks{suffix}"
            rep[path] = ranks_held(f"{n}-rank NCCL", ranks, k, lr, expected_launches(
                key, FlickrConfig(batch_size=rows)), failures)
            launches[path] = ranks[0][f"{k}_launches"]
            MESH_PATHS[path] = (key, (None, rows, T_TRAIN), 1)
            PATH_KERNELS[path] = PATH_KERNELS[key]
    return launches, rep


def phase_scale_out(dev, failures, detail, artifact):
    """14a-14f: the sharded paths at full width on a mesh of SLOTS slots on
    the card against their one-device runs. Returns (launches, kernel
    summaries, report) of MESH_PATHS."""
    import numpy as np

    from lrp_imagecaptioning_torch.config import FlickrConfig
    from lrp_imagecaptioning_torch.models.captioner import build_captioner
    from lrp_imagecaptioning_torch.parallel import make_mesh
    from lrp_imagecaptioning_torch.train.lrp_finetune import (make_lrp_finetune_step,
                                                              make_sharded_lrp_finetune_step)
    from lrp_imagecaptioning_torch.train.optimizer import make_optimizer
    from lrp_imagecaptioning_torch.train.step import make_sharded_train_step, make_train_step

    work = os.path.join(HERE, "build", "phase14")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mesh = make_mesh(devices=[dev] * SLOTS)
    cfg = FlickrConfig()
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    params = cap.init_params(seed=0, device=dev)
    launches, summary, rep = {}, {}, {"slots": [str(d) for d in mesh.slots]}
    per_slot = lambda want: {k: SLOTS * v for k, v in want.items()}   # noqa: E731

    def train():
        opt = make_optimizer("adaptiveattention", cfg.learning_rate)
        batch, *accuracy = accuracy_batch(cap, params, train_batch(
            torch.Generator(device=dev).manual_seed(14), dev, B_TRAIN, T_TRAIN), 15, dev)
        r = rep["train"] = mesh_step(
            "14a train step", lambda o: make_train_step(cap, o),
            lambda o: make_sharded_train_step(cap, o, mesh)[0], params, batch, 15, opt,
            per_slot(expected_launches("train", cfg)), failures, dev, accuracy)
        launches["mesh_train"] = r["launches"]

    def vocab():
        from lrp_imagecaptioning_torch.parallel import place_params

        vocab_mesh = make_mesh(devices=[dev] * SLOTS, model_parallel=SLOTS)
        opt = make_optimizer("adaptiveattention", cfg.learning_rate)
        batch, *accuracy = accuracy_batch(cap, params, train_batch(
            torch.Generator(device=dev).manual_seed(18), dev, B_TRAIN, T_TRAIN), 19, dev)
        r = rep["vocab_train"] = mesh_step(
            f"14a train step, the vocabulary split over {SLOTS} model slots",
            lambda o: make_train_step(cap, o),
            lambda o: make_sharded_train_step(cap, o, vocab_mesh, shard_vocab=True)[0], params,
            batch, 19, opt, expected_launches("train", cfg), failures, dev, accuracy,
            sharded_params=place_params(vocab_mesh, params, shard_vocab=True))
        launches["vocab_train"] = r["launches"]

    def finetune():
        opt = make_optimizer("adaptiveattention", 1e-6)
        stop = np.zeros(VOCAB + 1, bool)
        batch, *accuracy = accuracy_batch(cap, params, train_batch(
            torch.Generator(device=dev).manual_seed(16), dev, B_TRAIN, T_TRAIN), 17, dev)
        r = rep["finetune"] = mesh_step(
            "14b fine-tune step", lambda o: make_lrp_finetune_step(cap, o, stop, SOS, EOS),
            lambda o: make_sharded_lrp_finetune_step(cap, o, mesh, stop, SOS, EOS), params,
            batch, 17, opt, per_slot(expected_launches(
                "finetune", FlickrConfig(batch_size=B_TRAIN // SLOTS))), failures, dev, accuracy)
        launches["mesh_finetune"] = r["launches"]

    def shard_words():
        image = serve_images(1, 14)[0]
        toks = np.random.default_rng(14).integers(3, VOCAB, T).astype(np.int32)   # no EOS
        for storage, path in ((None, "shard_words_f32"), (torch.bfloat16, "shard_words_bf16")):
            one = explainer_for(cap, params, dev, storage_dtype=storage)
            ex = explainer_for(cap, params, dev, storage_dtype=storage, mesh=mesh,
                               shard_words=True, batch_size=B_MAIN)
            one.analyze(image, toks)
            ex.analyze(image, toks)     # both capture their graphs
            ref, ms1 = timed(one.analyze, image, toks)
            got, ms2, counted = counted_run(ex.analyze, image, toks)
            want = per_slot(explain_launches("adaptiveattention", storage, [(1, T // SLOTS)]))
            dist = mesh_held([got], [ref], f"14c {path}", failures, storage)
            rep[path] = dict(ms_one_device=ms1, ms_mesh=ms2, dist=dist, launches=counted,
                             expected=want)
            log(f"  14c word-sharded analyze, {storage or 'f32'}, one image at bucket {T}: one "
                f"device {ms1:.1f} ms, {SLOTS} slots on the card {ms2:.1f} ms; against one "
                f"device {dist}; launches {counted}")
            if counted != want:
                failures.append(f"14c {path}: launches {counted}, {want} derived")
            launches[path] = counted
            del one, ex
            gc.collect()

    def many_and_service():
        from lrp_imagecaptioning_torch.infer.serving import CaptionService

        images, toks, lengths = natural_workload()
        images, toks, lengths = images[:B_BF16], toks[:B_BF16], lengths[:B_BF16]
        bf = torch.bfloat16
        one = explainer_for(cap, params, dev, storage_dtype=bf, batch_size=B_BF16)
        ex = explainer_for(cap, params, dev, storage_dtype=bf, batch_size=B_BF16, mesh=mesh)
        one.analyze_many(images, toks)
        ex.analyze_many(images, toks)
        ref, ms1 = timed(one.analyze_many, images, toks)
        got, ms2, counted = counted_run(ex.analyze_many, images, toks)
        ((_, bucket),) = sorted_plan(lengths, B_BF16)
        want = explain_launches("adaptiveattention", bf, [(B_BF16 // SLOTS, bucket)] * SLOTS)
        dist = mesh_held(got, ref, "14d analyze_many bf16", failures, bf)
        rep["mesh_bf16"] = dict(img_per_s_one_device=B_BF16 / ms1 * 1e3,
                                img_per_s_mesh=B_BF16 / ms2 * 1e3, bucket=bucket, dist=dist,
                                launches=counted, expected=want)
        log(f"  14d analyze_many, bf16, {B_BF16} natural-length captions (bucket {bucket}): one "
            f"device {rep['mesh_bf16']['img_per_s_one_device']:.2f} img/s, {SLOTS} slots of "
            f"{B_BF16 // SLOTS} on the card {rep['mesh_bf16']['img_per_s_mesh']:.2f} img/s; "
            f"against one device {dist}; launches {counted}")
        if counted != want:
            failures.append(f"14d mesh_bf16: launches {counted}, {want} derived")
        launches["mesh_bf16"] = counted
        MESH_PATHS["mesh_bf16"] = ("serve_bf16", (bf, B_BF16 // SLOTS, bucket), SLOTS)
        del one, ex
        gc.collect()

        images = serve_images(B_MESH_SERVE, 12)
        kw = dict(batch_size=B_MESH_SERVE, beam_size=BEAM, max_len=T, device=dev)
        svc1 = CaptionService(cap, params, CaptionPP(), **kw)
        svc2 = CaptionService(cap, params, CaptionPP(), mesh=mesh, **kw)
        svc1.explain(images)
        svc2.explain(images)
        ref, ms1 = timed(svc1.explain, images)
        got, ms2, counted = counted_run(svc2.explain, images)
        plan = sorted_plan([len(e.words) for e in got], B_MESH_SERVE)
        ((_, bucket),) = plan
        want = explain_launches("adaptiveattention", None,
                                [(B_MESH_SERVE // SLOTS, bucket)] * SLOTS, decodes=SLOTS)
        caps_equal = svc2.caption(images) == svc1.caption(images)
        dist = mesh_held(got, ref, "14d CaptionService", failures)
        rep["mesh_serve"] = dict(ms_one_device=ms1, ms_mesh=ms2, bucket=bucket,
                                 captions_equal=caps_equal, dist=dist, launches=counted,
                                 expected=want)
        log(f"  14d CaptionService(mesh) explain of {B_MESH_SERVE}: one device {ms1:.1f} ms, "
            f"{SLOTS} slots on the card {ms2:.1f} ms; captions equal {caps_equal}; against one "
            f"device {dist}; launches {counted}")
        if counted != want:
            failures.append(f"14d mesh_serve: launches {counted}, {want} derived")
        if not caps_equal:
            failures.append("14d: the mesh service's captions differ from one device's")
        launches["mesh_serve"] = counted
        MESH_PATHS["mesh_serve"] = ("serve_f32", (None, B_MESH_SERVE // SLOTS, bucket), SLOTS)
        del svc1, svc2
        gc.collect()

    def exported():
        from types import SimpleNamespace

        from lrp_imagecaptioning_torch.infer.export import ExportedCaptioner

        if artifact is None:
            raise RuntimeError("phase 12's artifact is not there (phase 12 did not export)")
        ec, load_ms = timed(lambda: ExportedCaptioner(artifact, devices=[dev] * SLOTS,
                                                      device=dev))
        images = serve_images(N_EXPORTED, 15)
        halves = (images[:B_MAIN], images[B_MAIN:])
        for h in halves:
            ec.explain(h)   # slot 0 captures every bucket the requests take
        ec.explain(images)  # and slot 1
        ref, ms1 = timed(lambda: [e for h in halves for e in ec.explain(h)])
        got, ms2, counted = counted_run(ec.explain, images)
        as_ns = lambda es: [SimpleNamespace(**e) for e in es]   # noqa: E731
        dist = mesh_held(as_ns(got), as_ns(ref), "14e exported", failures,
                         exact_tol=TOL_EXPORTED)
        plan = [sorted_plan([len(e["words"]) for e in got[i:i + B_MAIN]], B_MAIN)[0]
                for i in range(0, N_EXPORTED, B_MAIN)]
        want = explain_launches("adaptiveattention", None, plan, decodes=len(plan))
        rep["mesh_exported"] = dict(load_s=load_ms / 1e3, ms_slot0_twice=ms1, ms_two_slots=ms2,
                                    plan=plan, dist=dist, launches=counted, expected=want)
        log(f"  14e ExportedCaptioner(devices=[{dev}] x {SLOTS}) over {N_EXPORTED} images: "
            f"load {load_ms / 1e3:.1f} s; each chunk on slot 0 {ms1:.1f} ms, dealt to both slots "
            f"{ms2:.1f} ms; against slot 0 {dist}; launches {counted}")
        if counted != want:
            failures.append(f"14e mesh_exported: launches {counted}, {want} derived")
        launches["mesh_exported"] = counted
        buckets = {w for _, w in plan}
        MESH_PATHS["mesh_exported"] = ("serve_f32", (None, B_MAIN, max(buckets)), len(plan))

    def multihost():
        mh_launches, rep["multihost"] = phase_multihost(dev, failures, work)
        launches.update(mh_launches)

    try:
        for title, fn in ((f"14a: one sharded train step at {B_TRAIN}, {SLOTS} slots", train),
                          (f"14a: one train step at {B_TRAIN}, the vocabulary split over "
                           f"{SLOTS} model slots", vocab),
                          (f"14b: one sharded fine-tune step at {B_TRAIN}", finetune),
                          ("14c: the word-sharded analyze, f32 and bf16", shard_words),
                          (f"14d: analyze_many bf16 at {B_BF16} and CaptionService at "
                           f"{B_MESH_SERVE} on the mesh", many_and_service),
                          ("14e: ExportedCaptioner over two slots", exported),
                          ("14f: process groups on the card, NCCL and gloo", multihost)):
            log(f" phase {title} ({host_gib()})")
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:  # noqa: BLE001 — a sub-phase that raises is recorded as failed
                traceback.print_exc()
                failures.append(f"phase {title} raised")
            gc.collect()
            torch.cuda.empty_cache()
            log(f"  ({time.perf_counter() - t0:.1f} s; {host_gib()})")
        for path in MESH_PATHS:
            if path in launches:
                summary[path] = mesh_summary(dev, path, failures, detail)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, summary, rep


# ---------------------------------------------------------------------------
# phase 15: the JAX package's call forms, through the package's exports
# ---------------------------------------------------------------------------

API_WORDS = T               # the word-batched call's seeds: one caption's words


def phase_api(dev, failures):
    """15: the calls a script written for the JAX package makes, with only
    the package renamed, at full width: ``vgg_lrp_alpha_beta`` with alpha,
    beta, bias, arch and until positional (K3 on W+ and W-: 48 launches,
    as phase 13's alpha2beta1 names), ``vgg_lrp_preset_a_wordbatched`` with
    arch, until, compute_dtype and storage_dtype positional (K4: 12), and
    ``init_vgg_params(gen, "vgg19")`` / ``vgg_apply(p, x, "vgg19")`` (VGG19's
    15 convs up to block5_conv3, no kernel), the Explainer built with the
    JAX package's positional arguments. K3's and K4's walks are held to
    their plain versions on the card: the f64 walk (the plain rule, cuDNN)
    and the bf16 walk with K4's plain version. Returns (launches, report)."""
    from lrp_imagecaptioning_torch import Explainer, FlickrConfig, build_captioner
    from lrp_imagecaptioning_torch.explain import cnn_lrp
    from lrp_imagecaptioning_torch.explain.analyzers import vgg_lrp_alpha_beta
    from lrp_imagecaptioning_torch.models import init_vgg_params, vgg_apply, vgg_layers
    from lrp_imagecaptioning_torch.ops import kernels
    from lrp_imagecaptioning_torch.weights import tree_to

    rep, launches = {}, {}
    none = dict.fromkeys(counts(), 0)
    until = "block5_conv3"

    # 15a: alpha2beta1, every argument positional, on phase 13's inputs
    params = analyzer_model(dev)
    images, seeds = analyzer_inputs(dev, B_MAIN, 31)
    def call():
        return vgg_lrp_alpha_beta(params, images, seeds, 2.0, 1.0, True, "vgg16", until)

    with torch.no_grad():
        call()
        out, ms, counted = counted_run(call)
        ref = vgg_lrp_alpha_beta(tree_to(params, dtype=torch.float64), images[:1].double(),
                                 seeds[:1].double(), 2.0, 1.0, True, "vgg16", until)
    want = dict(none, conv3x3_fused=2 * 2 * CONVS)
    dist = map_dist(out[:1].double(), ref)
    floor = ANALYZER_FLOOR["lrp.alpha_2_beta_1"]
    rep["alpha_beta"] = dict(ms=ms, img_per_s=B_MAIN / ms * 1e3, launches=counted, expected=want,
                             image0_vs_plain_f64=dist, floor=floor)
    launches["api_alpha_beta"] = counted
    log(f"  15a vgg_lrp_alpha_beta(params, images, seeds, 2.0, 1.0, True, 'vgg16', '{until}'), "
        f"batch {B_MAIN}: {ms:.1f} ms; launches {counted}; image 0 vs the plain rule in f64: "
        f"{dist:.3e} (floor {floor:.1e})")
    if counted != want:
        failures.append(f"15a alpha2beta1: launches {counted}, {want} derived")
    if dist > floor or tuple(out.shape) != tuple(images.shape):
        failures.append(f"15a alpha2beta1: {tuple(out.shape)}, {dist:.3e} from f64 (floor "
                        f"{floor:.1e})")
    del out, ref

    # 15b: PresetA word-batched in bf16 storage on K4, arch .. storage_dtype positional
    image, wseeds = analyzer_inputs(dev, 1, 33, words=API_WORDS)
    wseeds = wseeds[0]
    def call():
        return cnn_lrp.vgg_lrp_preset_a_wordbatched(params, image, wseeds, "vgg16", until, None,
                                                    torch.bfloat16)

    with torch.no_grad():
        call()
        out, ms, counted = counted_run(call)
        p16 = tree_to(params, dtype=torch.bfloat16)
        _, inputs = cnn_lrp.vgg_apply_with_acts(p16, image.to(torch.bfloat16), "vgg16", until)
        kernels.reset_launches()
        plain = cnn_lrp._backward(p16, inputs, wseeds.to(torch.bfloat16), "vgg16", until,
                                  kernels.lrp_a1b0_fused_plain).float()
        plain_launches = counts()
        f64 = cnn_lrp.vgg_lrp_preset_a_wordbatched(tree_to(params, dtype=torch.float64),
                                                   image.double(), wseeds.double(), "vgg16",
                                                   until)
    want = dict(none, lrp_a1b0_fused=CONVS)
    k4_d, plain_d = rel_err(out.double(), f64)[1], rel_err(plain.double(), f64)[1]
    direct = rel_err(out, plain)[1]
    rep["wordbatched_bf16"] = dict(ms=ms, maps_per_s=API_WORDS / ms * 1e3, launches=counted,
                                   expected=want, vs_f64=k4_d, plain_vs_f64=plain_d,
                                   vs_plain=direct)
    launches["api_wordbatched_bf16"] = counted
    log(f"  15b vgg_lrp_preset_a_wordbatched(params, image, seeds, 'vgg16', '{until}', None, "
        f"torch.bfloat16), {API_WORDS} words: {ms:.1f} ms; launches {counted}; from f64: K4 "
        f"{k4_d:.3e}, the plain version {plain_d:.3e}; K4 vs plain {direct:.3e}")
    if counted != want or plain_launches != none:
        failures.append(f"15b wordbatched bf16: launches {counted} ({want} derived), the plain "
                        f"walk's {plain_launches}")
    if not bool(torch.isfinite(out).all()) or k4_d > BF16_CPU_RATIO * plain_d:
        failures.append(f"15b wordbatched bf16: K4 {k4_d:.3e} from f64, the plain version "
                        f"{plain_d:.3e}")
    del out, plain, f64, inputs

    # 15c: VGG19 from the JAX forms, against the keyword forms, bit for bit
    gen = torch.Generator().manual_seed(19)
    p19 = tree_to(init_vgg_params(gen, "vgg19"), dev)
    kw19 = tree_to(init_vgg_params(torch.Generator().manual_seed(19), arch="vgg19",
                                   until=until), dev)
    same_init = all(torch.equal(p19[k][n], kw19[k][n]) for k in p19 for n in ("kernel", "bias"))
    x = images[:2]
    with torch.no_grad():
        feats, ms, counted = counted_run(lambda: vgg_apply(p19, x, "vgg19"))
        kw_feats = vgg_apply(p19, x, arch="vgg19", until=until)
    convs = sum(op[0] == "conv" for op in vgg_layers("vgg19"))
    rep["vgg19"] = dict(ms=ms, convs=convs, launches=counted, same_init=same_init,
                        bitwise=bool(torch.equal(feats, kw_feats)), shape=tuple(feats.shape))
    log(f"  15c vgg_apply(init_vgg_params(gen, 'vgg19'), x, 'vgg19'): {convs} convs, features "
        f"{tuple(feats.shape)} in {ms:.1f} ms, the keyword form's bit for bit "
        f"{rep['vgg19']['bitwise']}, the same init {same_init}; launches {counted}")
    if convs != 15 or not same_init or not rep["vgg19"]["bitwise"] or counted != none \
            or tuple(feats.shape) != (2, IMAGE // 16, IMAGE // 16, 512):
        failures.append(f"15c vgg19: {rep['vgg19']}")

    # 15d: the package's exports, the Explainer with JAX's positional arguments
    cfg = FlickrConfig()
    cap = build_captioner("adaptiveattention", cfg, VOCAB)
    ex = Explainer(cap, cap.init_params(0, device=dev), CaptionPP(), "lrp", BEAM, T,
                   torch.bfloat16, BUCKETS, None, False, device=dev)
    got = (ex.method, ex._beam_size, ex._max_len, ex._storage_dtype, ex._buckets, ex._mesh,
           ex._shard_words)
    rep["explainer"] = [str(v) for v in got]
    log(f"  15d Explainer(cap, params, pp, 'lrp', {BEAM}, {T}, torch.bfloat16, {BUCKETS}, None, "
        f"False): method, beam, max_len, storage, buckets, mesh, shard_words {rep['explainer']}")
    if got != ("lrp", BEAM, T, torch.bfloat16, tuple(w for w in BUCKETS if w < T), None, False):
        failures.append(f"15d Explainer: {rep['explainer']}")
    del ex, cap
    return launches, rep


CARD_TESTS = ["tests/test_torch_kernels.py", "tests/test_torch_graphs.py",
              "tests/test_torch_train_card.py", "tests/test_torch_explainer_card.py",
              "tests/test_torch_trainer_card.py", "tests/test_torch_encoders_card.py",
              "tests/test_torch_serving_card.py", "tests/test_torch_analyzers_card.py"]


def phase_card_tests(failures):
    """The tests marked ``cuda`` (kernel edges, graphs against eager), in a
    child pytest without the repo's conftest (it imports JAX)."""
    gc.collect()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
           "-p", "no:cacheprovider", *CARD_TESTS]
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    log(f"  {' '.join(cmd[2:])}: rc {proc.returncode}, {summary}")
    if proc.returncode != 0:
        log("\n".join(lines[-40:]))
        failures.append(f"card tests failed: {summary}")
    return dict(rc=proc.returncode, summary=summary)


def main(argv=None) -> int:
    """With no arguments every phase runs. ``--only KEY[,KEY]`` (debugging:
    e.g. ``--only serve``) builds the kernels and runs those phases alone,
    then exits 0 or 1 without the result lines."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma-separated phase keys")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from lrp_imagecaptioning_torch.ops import _build, kernels
    from lrp_imagecaptioning_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    failures: list[str] = []
    report: dict = {}

    log("phase 1: card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card_line = card[0] if card else ""
    if not card_line:
        failures.append("nvidia-smi gave no card line")
    log(f"  {card_line} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    report["host"] = probe_host()
    log("  host offers: " + ", ".join(f"{k} {'yes' if v else 'no'}"
                                      for k, v in report["host"].items()))

    phases = [(f"phase 2: kernels vs plain versions, the f32 path's shapes, batch {B_MAIN}",
               "kernels"),
              (f"phase 3: main path at full width, f32, batch {B_MAIN}", "main"),
              ("phase 4: card vs CPU, one image, f32", "cpu"),
              (f"phase 3b: main path at full width, bf16 storage, batch {B_BF16}", "main_bf16"),
              ("phase 4b: card vs CPU, one image, bf16", "cpu_bf16"),
              (f"phase 6: train steps at full width, batch {B_TRAIN}", "train"),
              (f"phase 6b: LRP-inference fine-tune steps at full width, batch {B_TRAIN}",
               "finetune"),
              (f"phase 6c: K steps a call, each replayed from a CUDA graph: train K = {K_TRAIN}, "
               f"fine-tune K = {K_FINETUNE}, batch {B_TRAIN}", "multi_step"),
              ("phase 7: card vs CPU, one fine-tune step, batch 1", "cpu_finetune"),
              (f"phase 8: the Explainer, adaptive attention, bf16 storage, {N_NATURAL} "
               f"natural-length captions at batch {B_BF16}", "explainer"),
              (f"phase 8b: the Explainer in f32 at batch {B_MAIN}, one image against the CPU",
               "explainer_f32"),
              (f"phase 8c: grid-TD lrp, f32 at batch {B_MAIN} and bf16 at batch {B_BF16}, one "
               "image against the CPU", "gridtd"),
              ("phase 8d: every gradient method, one image, a 4-word caption", "gradients"),
              (f"phase 9: the entry points at full width on a generated dataset, batch {B_TRAIN}",
               "entry_points"),
              ("phase 10: the explanation entry points on phase 9's checkpoint: deep_taylor and "
               "deep_lift, evaluate-bbox, analyze-words, the drivers, the CLI, word vectors",
               "explanations"),
              ("phase 11: the other configurations at full width: ResNet-101/50, InceptionV3 "
               "+ grid-TD, AOA, VGG19", "configs"),
              ("phase 12: the serving entry points at full width: CaptionService, HTTP, gRPC, "
               "export, the CLI's serve", "serve"),
              (f"phase 12g: every gradient method through export_serving at batch {B_MAIN}, "
               f"buckets {list(EXPORT_BUCKETS)} + T (--only export_grad)", "export_grad"),
              (f"phase 13: the analyzer catalogue at full width: the 32 names at batch {B_MAIN}, "
               f"the wrappers, imgword_batched at {B_MAIN} x {N_WORDS_13}, perturbation",
               "analyzers"),
              (f"phase 14: scale-out at full width on a {SLOTS}-slot mesh on the card: the "
               "sharded train and fine-tune steps, the word-sharded and mesh Explainer, the mesh "
               "CaptionService, exported serving over two slots, process groups", "scale_out"),
              ("phase 15: the JAX package's call forms through the package exports, full "
               "width: alpha2beta1 on K3, word-batched bf16 on K4, VGG19", "api"),
              ("phase 5: card tests", "card_tests")]
    summary = built = handoff = None
    launches = {}   # path -> {kernel: launches in its counted pass}
    explainer_launches = {}   # the Explainer's runs: each held to its own plan
    t_start = time.perf_counter()
    if only is not None:
        _build.build_all()
        summary = {name: {} for name in KERNEL_META}
        phases = [(title, key) for title, key in phases if key in only]
    else:   # 12g runs on request only: seven artifacts at two buckets each
        phases = [(title, key) for title, key in phases if key != "export_grad"]
    for title, key in phases:
        log(title)
        t0 = time.perf_counter()
        try:
            if key == "kernels":
                _build.build_all()
                log(f"  built in {time.perf_counter() - t0:.1f} s")
                for stem, text in _build.build_log.items():
                    for line in text.splitlines():
                        if "registers" in line or "spill" in line:
                            log(f"  {stem}: {line.strip()}")
                # ptxas reports static shared memory; these two take dynamic
                smem = _build.kernel_fn("lrp_a1b0_fused_smem_bytes")
                conv_smem = _build.kernel_fn("conv3x3_fused_smem_bytes")
                log(f"  dynamic shared memory: lrp_a1b0_fused {smem(64)} bytes (Cin <= 64, "
                    f"4 warps), {smem(128)} bytes (Cin > 64, 8 warps); conv3x3_fused "
                    f"{conv_smem(0)} bytes (8x16 pixels x 64 Cout, 4 warps), {conv_smem(1)} "
                    f"bytes (4x16 x 32, 2 warps); the other kernels 0")
                summary, report["kernel_shapes"] = phase_kernels(dev, failures)
            elif key == "main":
                built = None
                dtype, batch, _ = PATHS["f32"]
                launches["f32"], report["main"], built = phase_main(dev, failures, batch, dtype)
            elif key == "main_bf16":
                built = None
                dtype, batch, _ = PATHS["bf16"]
                launches["bf16"], report["main_bf16"], built = phase_main(
                    dev, failures, batch, dtype)
            elif key in ("train", "finetune", "cpu_finetune"):
                built = None
                torch.cuda.empty_cache()
                if key == "train":
                    launches["train"], report["train"] = phase_train(dev, failures)
                elif key == "finetune":
                    launches["finetune"], report["finetune"] = phase_finetune(dev, failures)
                else:
                    report["cpu_finetune"] = phase_finetune_cpu(dev, failures)
            elif key == "multi_step":
                built = None
                gc.collect()
                torch.cuda.empty_cache()
                multi_launches, report["multi_step"] = phase_multi_step(dev, failures)
                launches.update(multi_launches)
                for path in multi_launches:
                    for name, s_ in mesh_summary(dev, path, failures, report.setdefault(
                            "kernel_shapes", {})).items():
                        summary.setdefault(name, {})[path] = s_
            elif key in ("explainer", "explainer_f32", "gridtd", "gradients"):
                # an Explainer refers to itself through its graphed stages: the
                # cyclic collector frees an earlier phase's graphs and pool
                gc.collect()
                torch.cuda.empty_cache()
                if key == "explainer":
                    report["explainer"] = phase_explainer(dev, failures)
                    explainer_launches["explainer_bf16"] = report["explainer"]["launches"]
                elif key == "explainer_f32":
                    report["explainer_f32"] = phase_explainer_f32(dev, failures)
                    explainer_launches["explainer_f32"] = report["explainer_f32"]["launches"]
                elif key == "gridtd":
                    gridtd_launches, report["gridtd"] = phase_gridtd(dev, failures)
                    launches.update(gridtd_launches)
                else:
                    report["gradients"] = phase_gradients(dev, failures)
                    explainer_launches["gradients"] = {
                        m: r["launches"] for m, r in report["gradients"].items()}
            elif key == "entry_points":
                built = None
                gc.collect()
                torch.cuda.empty_cache()
                entry_launches, report["entry_points"], handoff = phase_entry_points(
                    dev, failures, report)
                launches.update(entry_launches)
            elif key == "explanations":
                gc.collect()
                torch.cuda.empty_cache()
                if handoff is None or summary is None:
                    failures.append(f"{title} skipped: phase 2 or 9 did not run")
                else:
                    plan_launches, plan_summaries, report["explanations"] = phase_explanations(
                        dev, failures, report, handoff, report["kernel_shapes"])
                    launches.update(plan_launches)
                    for path, by_kernel in plan_summaries.items():
                        for name, s in by_kernel.items():
                            summary[name][path] = s
                    handoff = None
                    expl = report["explanations"]
                    if "deep_lift" in expl.get("deep", {}):
                        explainer_launches["deep_lift"] = expl["deep"]["deep_lift"]["launches"]
                    if "words" in expl:
                        explainer_launches["word_stats"] = expl["words"]["launches"]
            elif key == "configs":
                gc.collect()
                torch.cuda.empty_cache()
                if summary is None:
                    failures.append(f"{title} skipped: phase 2 did not run")
                else:
                    config_launches, config_summaries, report["configs"] = phase_configs(
                        dev, failures, report["kernel_shapes"])
                    launches.update(config_launches)
                    for path, by_kernel in config_summaries.items():
                        for name, s_ in by_kernel.items():
                            summary[name][path] = s_
            elif key == "serve":
                gc.collect()
                torch.cuda.empty_cache()
                serve_launches, serve_summaries, report["serve"] = phase_serve(
                    dev, failures, report.get("kernel_shapes") or {})
                launches.update(serve_launches)
                for path, by_kernel in serve_summaries.items():
                    for name, s_ in by_kernel.items():
                        summary.setdefault(name, {})[path] = s_
            elif key == "export_grad":
                gc.collect()
                torch.cuda.empty_cache()
                report["export_grad"] = phase_export_grad(dev, failures)
            elif key == "analyzers" and summary is None:
                failures.append(f"{title} skipped: phase 2 did not run")
            elif key == "analyzers":
                gc.collect()
                torch.cuda.empty_cache()
                an_launches, an_summaries, report["analyzers"] = phase_analyzers(
                    dev, failures, report.setdefault("kernel_shapes", {}))
                launches.update(an_launches)
                for path, by_kernel in an_summaries.items():
                    for name, s_ in by_kernel.items():
                        summary.setdefault(name, {})[path] = s_
            elif key == "scale_out":
                gc.collect()
                torch.cuda.empty_cache()
                mesh_launches, mesh_summaries, report["scale_out"] = phase_scale_out(
                    dev, failures, report.setdefault("kernel_shapes", {}),
                    (report.get("serve") or {}).get("artifact"))
                launches.update(mesh_launches)
                for path, by_kernel in mesh_summaries.items():
                    for name, s_ in by_kernel.items():
                        summary.setdefault(name, {})[path] = s_
            elif key == "api":
                gc.collect()
                torch.cuda.empty_cache()
                api_launches, report["api"] = phase_api(dev, failures)
                explainer_launches.update(api_launches)
            elif key == "card_tests":
                built = None
                report["card_tests"] = phase_card_tests(failures)
            elif built is None:
                failures.append(f"{title} skipped: its main path did not run")
            elif key == "cpu":
                report["cpu"] = phase_cpu(built, failures)
            else:
                report["cpu_bf16"] = phase_cpu_bf16(built, failures)
        except Exception:  # noqa: BLE001 — a phase that raises is recorded as failed
            traceback.print_exc()
            failures.append(f"{title} raised")
        report.setdefault("phase_seconds", {})[key] = time.perf_counter() - t0
        log(f"  ({report['phase_seconds'][key]:.1f} s; {host_gib()})")
    report["seconds"] = time.perf_counter() - t_start
    shutil.rmtree(os.path.join(HERE, "build", "phase12"), ignore_errors=True)   # 12d's artifact

    kernels_line = []
    all_paths = set(PATHS) | set(PLAN_PATHS) | set(ANALYZER_PATHS) | set(MESH_PATHS)
    if summary is not None and set(launches) == all_paths:
        for name, (source, replaces, _) in KERNEL_META.items():
            by_path = summary[name]
            # each path must launch its kernels exactly as often as phase 2's
            # shapes (phase 10's chunks for PLAN_PATHS) say (per batch: K1 and
            # K2 once per step, whatever the batch), and the other path's not at all
            for path in (*PATHS, *PLAN_PATHS, *ANALYZER_PATHS, *MESH_PATHS):
                want = by_path[path]["calls_per_batch"] if path in by_path else 0
                if launches[path][name] != want:
                    failures.append(f"{name}: {launches[path][name]} launches on the {path} "
                                    f"path, {want} expected")
            # the line's numbers are those of the first path the kernel is on;
            # by_path has every path's
            path = next(iter(by_path))
            s = by_path[path]
            kernels_line.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=launches[path][name], max_abs_err=s["max_abs_err"], ms=s["ms"],
                plain_ms=s["plain_ms"], bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                library_ms=s["library_ms"], tflops=s["tflops"],
                share_of_bound=s["share_of_bound"], max_rel_err=s["max_rel_err"], path=path,
                calls_per_batch=s["calls_per_batch"],
                by_path={p: dict(v, launches=launches[p][name]) for p, v in by_path.items()},
                launches_by_path={p: launches[p][name] for p in launches},
                explainer_launches={p: ({m: c[name] for m, c in v.items()} if p == "gradients"
                                        else v[name]) for p, v in explainer_launches.items()},
                **{k: s[k] for k in ("eager_ms", "library_eager_ms", "tc_tflops",
                                     "bound_cuda_core_ms", "share_of_cuda_core_bound") if k in s},
                **({"backward_ms_train": by_path["train"]["backward_ms"],
                    "plain_backward_ms_train": by_path["train"]["plain_backward_ms"]}
                   if "backward_ms" in by_path.get("train", {}) else {}),
                **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {})))
    report.update(card=card_line, kernels=kernels_line, by_path=summary, failures=failures)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    if failures:
        for msg in failures:
            print(f"FAILED: {msg}", file=sys.stderr)
        return 1
    if only is not None:
        log(f"--only {sorted(only)}: passed; no result lines for a partial run")
        return 0
    print(json.dumps({"kernels": kernels_line}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
