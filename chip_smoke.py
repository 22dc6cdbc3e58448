#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`stf_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card, its power limit, and the torch / CUDA versions;
  2. build the five CUDA libraries (nvcc, sm_90a) and the rANS library from
     the sources in this checkout, all compilers started at once;
  3. kernel B1 (window attention) against its plain PyTorch version at
     WACNN's two attention geometries, STF's four stage geometries
     (window 4, head width 16; DYSTF's are the same) and TBC's six (8x8
     windows at head widths 4, 6, 8 and 10, its hyper stacks' 4x4 at 6;
     the widths that are not a multiple of 8 run padded to one inside the
     kernel) for batch 2 with shift labels, two
     launches bit-equal, timed beside SDPA with the same mask; under
     autograd (`WindowAttentionFunction`: the kernel forward, the
     closed-form backward) d qkv and d bias within ATTN_GRAD_TOL of the
     plain version's autograd gradients at each geometry; with the
     bias x30, no farther than the f32 plain version from an f64 one, at
     the first geometry of each instance; then B1's bf16
     instances at the bench path's shapes (`phase_attention_bf16`: WACNN's
     two g_a geometries at batch 24, STF's four analysis stages at batch
     8) and at TBC's bf16 analysis shapes (batch 2) against the bf16 plain
     version, within one bf16 ulp, for both
     designs of the products (bf16 mma.sync, the codec's, and TF32 on
     the converted values), each timed beside the plain version and SDPA;
  4. kernel B2 (lane-rANS decode) against its plain version and the
     encoded symbols, on seeded streams with 1% escapes at the main path's
     98,304 symbols a slice (banks bucketed as the codec buckets them) and
     at 1,179,648 (one Kodak-size slice at batch 24);
  5. kernel B3 (lane-rANS encode) on the same two streams: its stream must
     equal the native host encoder's field by field, and its outputs the
     plain version's;
  6. kernel B4 (layout pin) on each of its paths: the fused decode's
     operands (packed mu and lm, NHWC-as-NCHW rv i32 and z_hat f32), a
     cropped lm view (the general path), and odd uint8, bf16, stride-0
     and misaligned views: bytes equal to the plain version's, the path
     the planner picks; the first five timed beside PyTorch's copy;
  6b. the 3xTF32 convolution (`phase_conv`, `layers/conv_core.py`) at
     the main path's shapes (CONV_SHAPES: the cells' slice stacks, hyper
     synthesis, WACNN's synthesis units and STF's end_conv at batch 24,
     two slice layers at batch 1): its largest error against an f64
     convolution no more than 4x cuDNN f32's (TF32 off), two launches
     bit-equal, every tile configuration and each image alone bit-equal
     to the batch's outputs; timed over graph replays under the table's
     configuration and every other, beside the plain version and cuDNN's
     F.conv2d, with the bound (2 M N K at 165 TFLOP/s, the tensor cores'
     495 TF32 over three products, or the bytes at 3.35 TB/s); then its
     transposed convolution (`phase_deconv`) at WACNN's four synthesis
     upsamplers at batch 24 and 1 (DECONV_SHAPES): packing, f64 error no
     more than DECONV_TOL x cuDNN f32's, batch and configuration bit-equal;
     timed in both forms beside the plain version and cuDNN's
     F.conv_transpose2d, with the bound;
  7. the slice end to end: a full-width WACNN (N=192, M=320, 10 slices)
     with seeded random weights compresses and decompresses two 512x768
     uint8 images with coder="lane" (y encoded by B3; fused and per-slice
     decompress), coder="host", and the lane coder's two fused encode
     tiers (full and split: one CUDA-graph replay of the encode; the
     first call captures it and decodes its stream as a self-check); the
     lane y-stream must equal the host lane encoder's on the same
     symbols, each tier's must equal it from byte 1 on with the
     fused-encode flag and no tier may be demoted, symbols and x_hat must
     agree across the paths, and each kernel's launch count must match
     the path (compress: 10 B3 launches; fused decompress: one graph
     replay, 10 B2 and 32 B4 launches, 21 of them on B4's packed path and
     11 on its transpose path, no hash fallback; a tier's replay: 10 B3
     launches and no B4 pin). It ends with
     warm medians of each compress and decompress and the device-busy
     share of one warm call of each compress;
  8. the same phase, with the same checks, for a full-width STF (embed 48,
     depths 2/2/6/2, heads 3/6/12/24, window 4, M=384, 12 slices): B1 runs
     12 times an analysis and 12 times a synthesis, B4 38 times a fused
     walk (25 packed, 13 transpose); then for the full-width TBC (B1 30
     times a compress: 12 analysis, 6 h_a, 6 + 6 hyper synthesis; 24 a
     decompress), CC and CC_GD (no B1; CC_GD's gates and masks drawn at
     random, a third of its gated channels masked) and DYSTF (B1 12 + 12,
     as STF; its analysis routes tokens). Each path's launch counts are
     set to 0 just before it and read just after; B1's STF row takes its
     launches from the STF path, TBC's rows from the TBC path, every other
     row from WACNN's; then `phase_tbc_bf16`: the full-width TBC through
     the bf16 codec (full tier, batch 2), B1's bf16 instances at TBC's
     analysis, launches by instance checked, the stream the per-slice
     one, symbols round trip, fused = per-slice x_hat;
  9. the codec as bench.py runs it (`phase_codec_bf16`), for the
     full-width WACNN and then STF: smooth_batch(24, 512, 768, seed=999)
     as uint8, cnn in bf16 at pipeline 2 on the full tier, stf in bf16 at
     pipeline 1 on the split tier with analysis and synthesis in chunks
     of 3: the tier's first call and a replay, the fused and per-slice
     decompress, the host coder (packed drain); symbols round trip, the
     three x_hat bit-equal, the tier's stream a per-slice codec's from
     byte 1, no demotion, each step's launches the path's (B1 in bf16 in
     the analysis, in f32 in the synthesis); warm medians, peak memory,
     device busy, and the PSNR against the f32 codec at the same weights;
 10. the eval CLI (`phase_eval_cli`): `stf_tpu_torch.cli.eval_model.main`
     on Kodak's layout (the same 24 images as PNGs, 16 at 512x768 and 8
     transposed to 768x512), for each full-width model saved with the
     port's `save_checkpoint`: the host and the lane coder at batch 1 in
     f32, the lane coder at batch 24 in bf16 with bench.py's options,
     and entropy estimation; the JSON document's keys, 24 reconstructions
     at their sizes, lane = host PSNR and MS-SSIM, --half within 0.05 dB,
     no demotion, B1 (f32 and bf16), B2, B3 and B4 launched by the runs;
     per-image warm and first-use times beside the reference's; then
     `prime_cache.main` for one bucket;
 11. the trainer, for the full-width WACNN and then STF (`phase_train`):
     30 steps of `make_train_step` on smooth_batch(8, 256, 256, seed=step)
     at bench.py's prelude lambda (0.013, 0.008); every loss finite, B1
     launched by each step exactly as its forward launches it (4 and 24;
     the backward launches none), every parameter's gradient finite and
     nonzero after step 1 (but the weights of layers fed only zeros), the
     aux loss falling; the warm median step time and one warm step's
     device time by kernel; a checkpoint saved and restored into a fresh
     trainer with equal states; B1 at the shapes and data of one step's
     calls (batch 8: WACNN's 64x64x192 and 16x16x320 maps, STF's
     128x128x48 down to 16x16x384), its forward within ATTN_TOL of the
     plain version and its Function's d qkv and d bias, for the step's
     own output gradients, within ATTN_GRAD_TOL of autograd through the
     plain version; and the trained model through the lane (fused and
     per-slice decompress) and host coders (`codec_round_trip`, the
     round trip of 7 and 8, which 12 and 13 share), symbols
     round-tripping, x_hat bit-equal, each step's B1-B4 launches the
     path's. This path's counts are set to 0 before its steps and read
     after them;
 12. DYSTF distillation (`phase_dytrain`): the trained STF saved by the
     zoo and read back with is_teacher (the --teacher-checkpoint route),
     the full-width DYSTF student, 20 steps of `make_dytrain_step` at
     8x256x256 (clf_weight 1): every loss part finite, B1 launched 24 +
     24 times a step (the student's training forward, the teacher's eval
     forward; the backward none), every student gradient finite and the
     predictors' nonzero, the teacher bit-unchanged; keep shares against
     their targets, the warm median step, one step's device time by kind
     and B1's backward in it; B1 under autograd at one step's calls (the
     routed blocks' merged tokens) against the plain version; the
     distilled DYSTF through the lane (fused and per-slice) and host
     coders, symbols round-tripping, x_hat bit-equal, each step's B1-B4
     launches the path's; and `dytrain.main` for one epoch on the eval
     phase's PNGs with --teacher-checkpoint;
 13. CC_GD gate-decorator pruning (`phase_train_gd`): the full-width
     CC_GD, 5 tock steps, one tick of 2 rounds (param_scale falls, only
     gates and masks move), `prune_export` with z's gate unmasked and
     `zoo.load_checkpoint` of the export on the card: its eval forward
     within 1e-5 of the gated model's, the lane and host round trips as in
     12 (B2, B3, B4 launched), parameter counts and warm codec medians
     beside the gated model's; then `eval_model.main -a cc_gd` on the
     export;
 14. multi-process training (`phase_parallel`), in child processes that
     `python -m torch.distributed.run` starts (this script's `--child`
     modes; each killed with its session and failing the smoke on an
     overrun of PAR_TIMEOUT): (a) the trainer CLI on the full-width STF
     (8x256x256 crops of the eval phase's PNGs, each linked twice: 6
     steps an epoch) over NCCL at world size 1 with --ckpt-format sharded
     for an epoch, then resumed from its save directory for one more:
     the first loss bit-equal to the single-process CLI's at the same
     seed, 6 steps after the resume, B1 24 times a step, the 5 warm
     steps' median and spread, the sharded save's, landing's, sidecar
     read-backs' and restore's seconds; (b) two ranks sharing the card
     over gloo (NCCL refuses two ranks on one card), DDP and --tp 2
     (fully_shard): 6 timed steps, the first 2 losses within rel 1e-5 of
     one process's steps on the same global batch, after the first
     update the parameters within 5e-4 and Adam's first moments within
     1e-3 of each tensor's largest entry, B1 24 times a step, the --tp 2
     state saved sharded and restored bit-equal, its sidecar equal to
     the ranks' last parameters; (c) (a)'s params sidecar read
     by `zoo.load_checkpoint` through `codec_round_trip`; (d) `python -m
     stf_tpu_torch.utils.flops -a stf` at 256x256 on the card equal to
     this process's CPU count, and each full-width model's count on the
     card. Each phase prints its wall seconds.

It prints each CUDA kernel's registers and spills as ptxas reports them,
the kernels' JSON line, then the card's name and power limit as
nvidia-smi gives them, and last one JSON line {"ok": true, "device": ...}.
Kernel times are CUDA-event means over replays of a CUDA graph of many
calls (`graph_ms`), each kernel's device time as the fused decompress
runs it, with the eager per-call time (which for a small kernel is its
Python wrapper's) beside it; the plain versions of B2 and B3 are timed
eagerly. The kernels line's B2 and B3 rows are timed at the main path's
98,304 symbols, the shape their launch counts come from. Codec times are
host clocks around synchronised work; bounds use the H100 SXM data-sheet
rates (3.35 TB/s, 67 TFLOP/s f32 without tensor cores). B2 and B3 also
print a chain floor: rows a group x the least latency of one row's
dependent shared loads and integer operations (LDS_CYCLES and
ALU_CYCLES each) at the card's maximum SM clock, B3's plus its escape
pass's chunk scans.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCH, HEIGHT, WIDTH = 2, 512, 768
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
ATTN_TOL = 1e-5
TF32X3_OPS_PER_S = 495e12 / 3  # the tensor cores' TF32 rate, 3 products
# the 3xTF32 convolution's main-path shapes: (label, C_in, C_out, k, H, W,
# batch); the first of each kernel size a kernels row, by the path that
# launches it most (the batch-1 one on the single cells' paths)
CONV_SHAPES = (
    ("slice 480->224 at 32x48", 480, 224, 3, 32, 48, 24),
    ("slice 224->176", 224, 176, 3, 32, 48, 24),
    ("slice 176->128", 176, 128, 3, 32, 48, 24),
    ("slice 128->64", 128, 64, 3, 32, 48, 24),
    ("slice 64->32", 64, 32, 3, 32, 48, 24),
    ("hyper 256->1152 at 16x24", 256, 1152, 3, 16, 24, 24),
    ("hyper 288->320 at 32x48", 288, 320, 3, 32, 48, 24),
    ("g_s unit 320->160 at 32x48", 320, 160, 1, 32, 48, 24),
    ("g_s unit 160->160 at 32x48", 160, 160, 3, 32, 48, 24),
    ("hyper 224->256 at 16x24", 224, 256, 3, 16, 24, 24),
    ("hyper 192->192 at 8x12", 192, 192, 3, 8, 12, 24),
    ("g_s unit 192->96 at 128x192", 192, 96, 1, 128, 192, 24),
    ("g_s unit 96->96 at 128x192", 96, 96, 3, 128, 192, 24),
    ("end_conv 48->192 at 256x384", 48, 192, 5, 256, 384, 24),
    ("end_conv 48->3 at 512x768", 48, 3, 3, 512, 768, 24),
    ("batch 1: slice 480->224", 480, 224, 3, 32, 48, 1),
    ("batch 1: slice 224->176", 224, 176, 3, 32, 48, 1),
)
CONV_TOL = 4  # the kernel's f64 error over cuDNN f32's, at most
# the transposed convolutions the kernel runs as four sub-pixel phases
# (WACNN's synthesis, 5x5 stride 2, at a 512x768 image): (label, C_in,
# C_out, H, W of the input, batch); the first of each form (phases, joint)
# at each batch a kernels row
DECONV_SHAPES = tuple(
    (label, ci, co, h, w, batch) for batch in (24, 1)
    for label, ci, co, h, w in (
        ("g_s deconv 320->192 at 32x48", 320, 192, 32, 48),
        ("g_s deconv 192->192 at 64x96", 192, 192, 64, 96),
        ("g_s deconv 192->192 at 128x192", 192, 192, 128, 192),
        ("g_s deconv 192->3 at 256x384", 192, 3, 256, 384)))
DECONV_TOL = 2.5  # the same for them (tests/test_torch_cuda.py)
# (model, feature map, channels, window, heads) of every attention geometry
# at a 512x768 input: WACNN's g_a/g_s blocks, STF's four Swin stages (head
# width 16 throughout; DYSTF's are the same), TBC's four analysis and
# synthesis stages (8x8 windows, 32 heads: head widths 4, 6, 8, 10) and its
# hyper stacks' two (4x4, 32 heads over 192: head width 6). The first
# geometry of each (window, head width) is that kernel's row in the kernels
# line.
ATTN_GEOMS = (
    ("cnn", (128, 192), 192, 8, 8),
    ("cnn", (32, 48), 320, 4, 8),
    ("stf", (256, 384), 48, 4, 3),
    ("stf", (128, 192), 96, 4, 6),
    ("stf", (64, 96), 192, 4, 12),
    ("stf", (32, 48), 384, 4, 24),
    ("tbc", (256, 384), 128, 8, 32),
    ("tbc", (128, 192), 192, 8, 32),
    ("tbc", (64, 96), 256, 8, 32),
    ("tbc", (32, 48), 320, 8, 32),
    ("tbc", (16, 24), 192, 4, 32),
    ("tbc", (8, 12), 192, 4, 32),
)
# B1 launches of each registry model in one analysis (g_a and h_a), one
# hyper synthesis (h_mean_s and h_scale_s) and one synthesis: a compress
# runs the first two, a decompress the last two. Only TBC's hyper stacks
# attend; CC and CC_GD run no B1.
B1_CALLS = {"cnn": (2, 0, 2), "stf": (12, 0, 12), "dystf": (12, 0, 12),
            "tbc": (12 + 6, 6 + 6, 12), "cc": (0, 0, 0), "cc_gd": (0, 0, 0)}
# the families of the codec phase, in order
CODEC_MODELS = ("cnn", "stf", "tbc", "cc", "cc_gd", "dystf")
# B1's gradients (the Function's closed-form backward) against autograd
# through the plain version: max abs difference over the largest plain
# gradient (f32 products summed in other orders; up to 3.3e-7 on an H100)
ATTN_GRAD_TOL = 1e-5
# the training phase: steps of batch x size x size smooth_batch crops at
# bench.py's prelude lambda (bench.py:51); steps after the first
# TRAIN_WARM are timed
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SIZE, TRAIN_WARM = 30, 8, 256, 5
TRAIN_LMBDA = {"cnn": 0.013, "stf": 0.008}
# bench.py's traffic and codec configuration (bench.py:281-304): 24
# Kodak-size images from smooth_batch(seed=999); cnn in bf16 at pipeline 2
# on the full fused tier, stf in bf16 at pipeline 1 on the split tier with
# analysis and synthesis in chunks of 3
BENCH_BATCH, BENCH_SEED = 24, 999
BENCH_CODEC = {
    "cnn": dict(pipeline=2, fused_encode=True),
    "stf": dict(pipeline=1, fused_encode="split", analyze_chunks=3,
                synth_chunks=3),
}
# (model, feature map, channels, window, heads, batch) of B1's bf16 calls
# on that path: WACNN's two g_a blocks at batch 24, STF's four analysis
# stages at its chunk's batch 8; and on the bf16 TBC round trip
# (`phase_tbc_bf16`, batch 2): its analysis stages and its h_a's first
# stage. The first of each (window, head width) is that instance's kernels
# row
ATTN_BF16_GEOMS = (
    ("cnn", (128, 192), 192, 8, 8, 24),
    ("cnn", (32, 48), 320, 4, 8, 24),
    ("stf", (256, 384), 48, 4, 3, 8),
    ("stf", (128, 192), 96, 4, 6, 8),
    ("stf", (64, 96), 192, 4, 12, 8),
    ("stf", (32, 48), 384, 4, 24, 8),
    ("tbc", (256, 384), 128, 8, 32, 2),
    ("tbc", (128, 192), 192, 8, 32, 2),
    ("tbc", (64, 96), 256, 8, 32, 2),
    ("tbc", (32, 48), 320, 8, 32, 2),
    ("tbc", (16, 24), 192, 4, 32, 2),
)
# the distillation phase: steps of TRAIN_BATCH x TRAIN_SIZE crops, the
# CLI's keep ratios; B1 launches a step: the student's training forward
# (analysis 12 + synthesis 12) and the frozen teacher's eval forward (STF's
# 12 + 12); the backward launches none
DYTRAIN_STEPS, DYTRAIN_LMBDA, DYTRAIN_KEEP = 20, 0.013, (0.9, 0.7, 0.5)
DYTRAIN_B1 = 24 + 24
# the pruning phase: tock steps, the CLI's sparse lambda, and one tick of
# GD_ROUNDS rounds over GD_SUBSET batches, GD_TICK_NUM channels a round
# (about 8% of the full-width CC_GD's 12,864 gated channels each)
GD_STEPS, GD_LMBDA, GD_SPARSE = 5, 0.013, 1e-4
GD_ROUNDS, GD_SUBSET, GD_TICK_NUM = 2, 2, 1000
WARM_CALLS = 3  # warm calls a median of the batch-24 phase takes
# TBC's warm medians at batch 2 over PR 13's smokes (ms), before B1's
# head-group design, printed beside this build's
TBC_PR13_MS = {"lane compress (B3, per-slice walk)": "42.58-42.64",
               "full-tier compress": "40.37-42.70",
               "split-tier compress": "41.09-42.84",
               "fused decompress": "39.43-40.80",
               "per-slice decompress": "45.13-47.83"}
# the lift of the scale stacks' last bias (`smoke_model`) by family
SCALE_LIFT = {"stf": 1.0, "dystf": 1.0}


def smooth_batch(n, h, w, seed):
    """Deterministic smooth synthetic photos: gradients + mild sensor
    noise, full [0, 1] range (the generator bench.py uses)."""
    import numpy as np

    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for _ in range(n):
        f1 = 2 * np.pi * r.uniform(0.5, 6) / w
        f2 = 2 * np.pi * r.uniform(0.5, 6) / h
        base = 0.5 + r.uniform(0.1, 0.35) * np.sin(
            xx * f1 + r.uniform(0, 7)
        ) * np.cos(yy * f2 + r.uniform(0, 7))
        img = np.stack(
            [base,
             np.roll(base, int(r.uniform(0, 64)), 1),
             np.roll(base, int(r.uniform(0, 64)), 0)],
            -1,
        )
        img += r.normal(0, 0.03, img.shape)
        imgs.append(np.clip(img, 0, 1))
    return np.stack(imgs).astype(np.float32)


def cuda_ms(fn, iters):
    """Mean milliseconds per call over `iters` calls, by CUDA events,
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, replays=5):
    """Device milliseconds per call: `iters` calls captured into one CUDA
    graph, replayed `replays` times between CUDA events after a warm-up
    replay. This is a kernel's time without the host's dispatch, as the
    fused decompress's graph runs it; `cuda_ms` of a call that launches
    one small kernel measures its Python wrapper instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile_call(fn, name, trace=None):
    """(wall s, device-busy s, device events) of one call of `fn` in a
    torch.profiler window of its own: busy is the sum of the device
    events' self times (the kernels and copies), without the device spans
    of record_function ranges (`is_range`; the events keep them); `trace`
    names a Chrome trace file to write. The first window in a process
    also pays the tracer's start-up, so spend one on an untimed call
    first."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(name):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and _device_us(e) > 0 and e.key != name
    ]
    # a range's device span (record_function) overlaps the kernels in it
    busy = sum(_device_us(e) for e in events if not is_range(e))
    return wall, busy / 1e6, events


def is_range(evt):
    """Whether a profiler event is a record_function range, not a kernel."""
    return bool(getattr(evt, "is_user_annotation", False))


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over `ops_per_s` (the f32 rate by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# special-function (MUFU) results an SM delivers a clock on Hopper, ex2
# among them: 4 a sub-partition
MUFU_PER_SM_CLOCK = 16


def softmax_floor(units, n, sm_mhz, sms):
    """ms the card's MUFU units need for a softmax's N^2 exps a (window,
    head), over `units` (window, head) pairs, at the SM clock `sm_mhz`."""
    return units * n * n / (sms * MUFU_PER_SM_CLOCK * sm_mhz * 1e6) * 1e3


def bf16_ulp_errors(got, want):
    """|got - want| in bf16 ulps of want, the ulp taken at no less than
    2^-12 of want's largest magnitude (bf16's ulp over [2^e, 2^(e+1)) is
    2^(e-7)): below that an attention output is the cancellation of much
    larger P * v terms, and the order of an f32 sum alone moves it by
    more than its own ulp."""
    import torch

    g, w = got.float(), want.float()
    mag = torch.clamp(w.abs(), min=w.abs().max().item() * 2.0 ** -12)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def b1_designs(ws, hd, nh, dtype):
    """B1's designs at a geometry, the wrapper's own (`main_design`)
    first: at TBC's 8x8 geometries the head group's and the window-head
    design it replaced (PR 13's), in bf16 also the TF32 products."""
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.layers import attention_core as ac

    group = _native.load("winattn").stf_window_attention_head_group_heads()
    main = ac.main_design(ws, hd, nh, dtype, group)
    others = (["bf16_mma", "tf32"] if dtype == torch.bfloat16
              else ["window_head"])
    if ac.head_group_fits(ws, hd, nh, group):
        others.insert(0, ac.HEAD_GROUP)
    return [main] + [d for d in others if d != main]


def time_designs(launch, designs, iters):
    """{design: device ms} of `launch(design)` over graph replays, each
    design timed twice, in order and then in reverse (for two designs:
    old, new, new, old), the mean of the two."""
    first = {d: graph_ms(lambda: launch(d), iters) for d in designs}
    second = {d: graph_ms(lambda: launch(d), iters) for d in designs[::-1]}
    return {d: (first[d] + second[d]) / 2 for d in designs}


def head_group_ptxas(hd, bf16):
    """ptxas's registers and spills of the head-group instance at head
    width `hd` (from the build's -Xptxas -v output), or ''."""
    from stf_tpu_torch import _native

    tag = f"head_group_kernelI{'13__nv_bfloat16' if bf16 else 'f'}Li{hd}E"
    for line in ptxas_summary(_native.build_logs.get("winattn", "")):
        if tag in line:
            return line.split(": ", 1)[1]
    return ""


def phase_attention_bf16(dev, sm_mhz):
    """B1's bf16 instances at the bench path's shapes and TBC's: each
    design (`b1_designs`: the wrapper's first; bf16 mma.sync, TF32 on the
    converted values, and at TBC's 8x8 geometries the head group's)
    against the bf16 plain version (at most one bf16 ulp an element,
    `bf16_ulp_errors`; two launches bit-equal); device times of each over
    graph replays in turns, the plain version's and SDPA's with the same
    mask on the same bf16 inputs; the bound at 2 bytes an element of qkv,
    bias and out, 4 a label, and B1's products at the bf16 tensor rate,
    and the softmax floor."""
    import torch
    import torch.nn.functional as F

    from stf_tpu_torch.layers import attention_core as ac
    from stf_tpu_torch.layers import shifted_window_region_labels

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for model, (h, w), C, ws, nh, batch in ATTN_BF16_GEOMS:
        N, hd = ws * ws, C // nh
        scale = hd ** -0.5
        qkv = torch.randn(batch, h, w, 3 * C, device=dev,
                          generator=gen).to(torch.bfloat16)
        bias = torch.randn(nh, N, N, device=dev, generator=gen).to(torch.bfloat16)
        labels = torch.from_numpy(
            shifted_window_region_labels(h, w, ws, ws // 2)
        ).to(dev)
        plain = ac.window_attention_plain(qkv, bias, labels, ws, scale)
        name = ac.launch_key(ws, hd, torch.bfloat16)
        designs = b1_designs(ws, hd, nh, torch.bfloat16)
        chosen = designs[0]
        errs = {}
        for design in designs:
            out = ac._launch(qkv, bias, labels, ws, scale, design)
            again = ac._launch(qkv, bias, labels, ws, scale, design)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"B1 {name} {design} {model} {h}x{w}: "
                                     "two launches differ")
            ulps = bf16_ulp_errors(out, plain)
            errs[design] = (ulps.max().item(), int((out != plain).sum()),
                            (out.float() - plain.float()).abs().max().item())
            if not errs[design][0] <= 1.0:
                raise AssertionError(f"B1 {name} {design} {model} {h}x{w}: "
                                     f"{errs[design][0]:.3g} bf16 ulps from "
                                     "the plain version")
        ms = time_designs(
            lambda d: ac._launch(qkv, bias, labels, ws, scale, d), designs, 20)
        if not torch.equal(ac.window_attention(qkv, bias, labels, ws, scale),
                           ac._launch(qkv, bias, labels, ws, scale, chosen)):
            raise AssertionError(f"B1 {name}: the wrapper did not launch the "
                                 f"{chosen} design")
        eager_ms = cuda_ms(
            lambda: ac.window_attention(qkv, bias, labels, ws, scale), 50)
        q, k, v = ac.partition_qkv(qkv, ws, nh)
        nW = labels.shape[0]
        mask = (bias[None, None].float()
                + ac.shift_penalty(labels)[None, :, None]).to(torch.bfloat16)
        mask = mask.expand(batch, nW, nh, N, N).reshape(-1, nh, N, N)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, scale=scale
        )
        lib_err = (ac.unpartition(sdpa(), batch, h, w, ws).float()
                   - plain.float()).abs().max().item()
        plain_ms = graph_ms(
            lambda: ac.window_attention_plain(qkv, bias, labels, ws, scale), 3)
        lib_ms = graph_ms(sdpa, 10)
        nbytes = (qkv.numel() + plain.numel() + bias.numel()) * 2 + labels.numel() * 4
        ops = 4 * N * N * hd * batch * nW * nh
        bound_ms, bound_by = bound(nbytes, ops, BF16_OPS_PER_S)
        floor_ms = softmax_floor(batch * nW * nh, N, sm_mhz, sms)
        regs = head_group_ptxas(hd, True) if chosen == ac.HEAD_GROUP else ""
        print(f"B1 {name} ({model}, batch {batch}): qkv {tuple(qkv.shape)} "
              + "; ".join(f"{d}: {e[0]:.3g} ulps at most, {e[1]} of "
                          f"{plain.numel()} elements differ, max abs {e[2]:.3g}, "
                          f"{ms[d]:.4f} ms ({100 * bound_ms / ms[d]:.1f}% of "
                          "bound)" for d, e in errs.items())
              + f"; deterministic; eager per call {eager_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
              f"(max abs {lib_err:.3g}) bound {bound_ms:.4f} ms ({bound_by}), "
              f"softmax floor {floor_ms:.4f} ms; {chosen} at "
              f"{100 * bound_ms / ms[chosen]:.1f}% of bound, "
              f"{lib_ms / ms[chosen]:.2f}x sdpa, "
              + ", ".join(f"{ms[d] / ms[chosen]:.2f}x {d}" for d in designs[1:])
              + (f"; {chosen} ptxas: {regs}" if regs else ""))
        if all(r["name"] != name for r in rows):
            rows.append(dict(
                name=name, route="cuda",
                source="stf_tpu_torch/csrc/window_attention.cu",
                replaces="stf_tpu/layers/pallas_attention.py:49",
                launches=None, max_abs_err=errs[chosen][2], ms=ms[chosen],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, eager_ms=eager_ms, softmax_floor_ms=floor_ms,
                design=chosen, other_design_ms={d: ms[d] for d in designs[1:]},
                path=f"{model}_bf16",
            ))
    return rows


def phase_attention(dev, sm_mhz):
    """B1 vs its plain version and SDPA at every model's attention
    geometries; at TBC's 8x8 geometries its head-group design (the
    wrapper's) and its window-head design, both checked and timed in
    turns."""
    import torch
    import torch.nn.functional as F

    from stf_tpu_torch.layers import attention_core as ac
    from stf_tpu_torch.layers import shifted_window_region_labels

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for model, (h, w), C, ws, nh in ATTN_GEOMS:
        N, hd = ws * ws, C // nh
        scale = hd ** -0.5
        qkv = torch.randn(BATCH, h, w, 3 * C, device=dev, generator=gen)
        bias = torch.randn(nh, N, N, device=dev, generator=gen)
        labels = torch.from_numpy(
            shifted_window_region_labels(h, w, ws, ws // 2)
        ).to(dev)
        out = ac.window_attention(qkv, bias, labels, ws, scale)
        plain = ac.window_attention_plain(qkv, bias, labels, ws, scale)
        torch.cuda.synchronize()
        again = ac.window_attention(qkv, bias, labels, ws, scale)
        name = f"window_attention_ws{ws}_hd{hd}"
        err = (out - plain).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"B1 {name} {model} {h}x{w}: max abs err "
                                 f"{err} > {ATTN_TOL}")
        if not torch.equal(out, again):
            raise AssertionError(f"B1 {name} {model} {h}x{w}: two launches "
                                 "differ")
        q, k, v = ac.partition_qkv(qkv, ws, nh)
        nW = labels.shape[0]
        mask = (bias[None, None] + ac.shift_penalty(labels)[None, :, None])
        mask = mask.expand(BATCH, nW, nh, N, N).reshape(-1, nh, N, N)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, scale=scale
        )
        lib_err = (ac.unpartition(sdpa(), BATCH, h, w, ws) - out).abs().max().item()
        gout = torch.randn(out.shape, device=dev, generator=gen)
        grad_errs = attention_grad_errors(qkv, bias, labels, ws, scale, gout)
        if not max(grad_errs) <= ATTN_GRAD_TOL:
            raise AssertionError(f"B1 {name} {model} {h}x{w}: gradients off by "
                                 f"{grad_errs} (relative)")
        q_, b_ = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        step_ms = [cuda_ms(lambda f=f: torch.autograd.grad(
            f(q_, b_, labels, ws, scale), (q_, b_), gout), 5)
            for f in (ac.window_attention, ac.window_attention_plain)]
        bwd_ms = graph_ms(lambda: ac.window_attention_backward(
            qkv, bias, labels, ws, scale, gout), 5)
        print(f"B1 {name} ({model}) under autograd: d qkv max abs err "
              f"{grad_errs[0]:.3g}, d bias {grad_errs[1]:.3g}, each over the "
              f"largest plain gradient (tolerance {ATTN_GRAD_TOL:g}); eager "
              f"forward + backward {step_ms[0]:.4f} ms, plain version's "
              f"{step_ms[1]:.4f} ms; the backward's device time "
              f"{bwd_ms:.4f} ms (graph replays)")
        kernel = lambda: ac.window_attention(qkv, bias, labels, ws, scale)  # noqa: E731
        designs = b1_designs(ws, hd, nh, torch.float32)
        for design in designs[1:]:  # the other designs: right, deterministic
            o1 = ac._launch(qkv, bias, labels, ws, scale, design)
            o2 = ac._launch(qkv, bias, labels, ws, scale, design)
            torch.cuda.synchronize()
            e = (o1 - plain).abs().max().item()
            if not (e <= ATTN_TOL and torch.equal(o1, o2)):
                raise AssertionError(f"B1 {name} {design} {model} {h}x{w}: "
                                     f"max abs err {e}, or two launches differ")
        times = time_designs(
            lambda d: ac._launch(qkv, bias, labels, ws, scale, d), designs, 20)
        ms = times[designs[0]]
        eager_ms = cuda_ms(kernel, 50)
        # the same launch without the autograd Function around it: the
        # host cost of entering the Function on the no-gradient path
        direct_ms = cuda_ms(
            lambda: ac._launch(qkv, bias, labels, ws, scale), 50)
        plain_ms = graph_ms(
            lambda: ac.window_attention_plain(qkv, bias, labels, ws, scale), 5
        )
        lib_ms = graph_ms(sdpa, 20)
        nbytes = (qkv.numel() + out.numel() + bias.numel() + labels.numel()) * 4
        windows = BATCH * nW
        ops = 4 * N * N * hd * windows * nh
        bound_ms, bound_by = bound(nbytes, ops)
        floor_ms = softmax_floor(windows * nh, N, sm_mhz,
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
        other = "".join(
            f"; {d} {times[d]:.4f} ms ({times[d] / ms:.2f}x, "
            f"{100 * bound_ms / times[d]:.1f}% of bound)" for d in designs[1:])
        regs = head_group_ptxas(hd, False) if designs[0] == ac.HEAD_GROUP else ""
        print(f"B1 {name} ({model}): qkv {tuple(qkv.shape)} max_abs_err "
              f"{err:.3g} deterministic (sdpa {lib_err:.3g}) {designs[0]} "
              f"{ms:.4f} ms{other} (eager per call {eager_ms:.4f} ms; without "
              f"the autograd Function {direct_ms:.4f} ms) plain {plain_ms:.4f} "
              f"ms sdpa {lib_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), "
              f"softmax floor {floor_ms:.4f} ms; {100 * bound_ms / ms:.1f}% of "
              f"bound, {lib_ms / ms:.2f}x sdpa"
              + (f"; {designs[0]} ptxas: {regs}" if regs else ""))
        if all(r["name"] != name for r in rows):
            rows.append(dict(
                name=name, route="cuda",
                source="stf_tpu_torch/csrc/window_attention.cu",
                replaces="stf_tpu/layers/pallas_attention.py:49",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                softmax_floor_ms=floor_ms, design=designs[0],
                other_design_ms={d: times[d] for d in designs[1:]},
                path=model,
            ))
    for name, err, plain_err, diff in attention_vs_f64(dev, 30.0):
        print(f"B1 {name}, bias x30 (logits to ~+-100): max abs err against "
              f"an f64 plain version {err:.3g} (f32 plain version "
              f"{plain_err:.3g}; kernel against it {diff:.3g})")
        if not err <= min(ATTN_TOL, plain_err):
            raise AssertionError(f"B1 {name} bias x30: {err} from f64, plain "
                                 f"version {plain_err}")
    return rows


def attention_grad_errors(qkv, bias, labels, ws, scale, gout):
    """B1 under autograd (`WindowAttentionFunction`: the kernel forward and
    the closed-form backward) against autograd through the plain version,
    for the output gradient `gout`: [d qkv error, d bias error], each the
    max abs difference over the largest plain gradient. Checks that the
    forward launched B1 once."""
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.layers import attention_core as ac

    def grads(fn):
        q = qkv.detach().clone().requires_grad_()
        b = bias.detach().clone().requires_grad_()
        return torch.autograd.grad(fn(q, b, labels, ws, scale), (q, b), gout)

    key = f"window_attention_ws{ws}_hd{qkv.shape[-1] // 3 // bias.shape[0]}"
    before = _native.launch_counts[key]
    got = grads(ac.window_attention)
    if _native.launch_counts[key] != before + 1:
        raise AssertionError(f"B1 {key}: the forward under autograd did not "
                             "launch the kernel once")
    want = grads(ac.window_attention_plain)
    return [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]


def attention_vs_f64(dev, bias_scale):
    """At the first geometry of each kernel (full maps, batch 2, shift
    labels) with the bias scaled by `bias_scale`: the max abs error of B1
    and of the f32 plain version against the plain version computed in
    f64."""
    import torch

    from stf_tpu_torch.layers import attention_core as ac
    from stf_tpu_torch.layers import shifted_window_region_labels

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs, seen = [], set()
    for _, (h, w), C, ws, nh in ATTN_GEOMS:
        N, hd = ws * ws, C // nh
        if (ws, hd) in seen:
            continue
        seen.add((ws, hd))
        scale = hd ** -0.5
        qkv = torch.randn(BATCH, h, w, 3 * C, device=dev, generator=gen)
        bias = torch.randn(nh, N, N, device=dev, generator=gen) * bias_scale
        labels = torch.from_numpy(
            shifted_window_region_labels(h, w, ws, ws // 2)
        ).to(dev)
        ref = ac.window_attention_plain(qkv.double(), bias.double(), labels,
                                        ws, scale)
        out = ac.window_attention(qkv, bias, labels, ws, scale)
        plain = ac.window_attention_plain(qkv, bias, labels, ws, scale)
        errs.append((f"window_attention_ws{ws}_hd{hd}",
                     (out.double() - ref).abs().max().item(),
                     (plain.double() - ref).abs().max().item(),
                     (out - plain).abs().max().item()))
    return errs


# symbols a slice on the main path (WACNN's M=320 over 10 slices at a
# 512x768 input, batch 2) and a Kodak-size slice at batch 24
LANE_MAIN_N = 98_304
LANE_BIG_N = 1_179_648
# Latencies for a chain floor, in SM cycles: a shared-memory load that
# waits on the one before, and an integer multiply-add that waits on the
# one before, as tools/compare_lane_decode.py measures them
# (tools/csrc/latency_probe.cu) on an H100 80GB HBM3: 28.6 and 4.5.
LDS_CYCLES = 28.6
ALU_CYCLES = 4.5


def chain_floor(steps, lds, alu, sm_mhz):
    """(ms, formula): the least time of `steps` dependent steps, each of
    `lds` dependent shared loads and `alu` dependent integer operations,
    at the SM clock."""
    cycles = lds * LDS_CYCLES + alu * ALU_CYCLES
    ms = steps * cycles / (sm_mhz * 1e3)
    return ms, (f"{steps} steps x ({lds} loads x {LDS_CYCLES:g} + {alu} ops x "
                f"{ALU_CYCLES:g} cycles) / {sm_mhz:g} MHz")


def lane_decode_floor(tg, width, sm_mhz):
    """Kernel B2's chain: a row's search halves the padded width log2(it)
    times; the first two halvings compare values read a row ahead
    (LANE_DECODE_PRE), each of the others waits on a shared load; the CDF
    pair and the word are one shared load each. ~3 integer operations a
    halving, 12 more for the slot, the update, the ballot, the rank and
    the word's merge."""
    levels = (int(width) - 1).bit_length()
    return chain_floor(tg, levels - min(2, levels) + 2, 12 + 3 * levels, sm_mhz)


def lane_encode_floor(tg, sm_mhz):
    """Kernel B3's chain: pass B's tg row steps, each one lane's state
    update and no dependent shared load (the stagers set its coding cells
    out ahead): the compare, the select, the multiply by the reciprocal,
    the remainder, its compare and correction, the shift-add and the add
    of cum, ~8 dependent integer operations; plus pass A's ceil(tg/32)
    chunks, each ~8 dependent shared-memory round trips (its two
    barriers, the scan's five shuffles, the max reduce)."""
    chunks = -(-int(tg) // 32)
    b_ms, b_formula = chain_floor(tg, 0, 8, sm_mhz)
    a_ms, a_formula = chain_floor(chunks, 8, 0, sm_mhz)
    return b_ms + a_ms, f"pass B {b_formula} + pass A {a_formula}"


def lane_inputs(n):
    """(tables, symbols, indexes): a seeded n-symbol slice with 1%
    escapes under the (64, 127) tables the codec uses."""
    import numpy as np

    from stf_tpu_torch.ans import lane_coder as lc
    from stf_tpu_torch.entropy import build_gc_tables, get_scale_table

    scales = get_scale_table()
    tables = lc.truncate_tables(*build_gc_tables(scales).astuple(), max_half=62)
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, 48, n).astype(np.int32)
    sym = np.rint(rng.normal(0, scales[idx] * 0.7)).astype(np.int32)
    esc = rng.random(n) < 0.01  # forced escapes beyond the ±62 window
    sym[esc] = rng.integers(63, 3000, int(esc.sum())) * rng.choice([-1, 1], int(esc.sum()))
    return tables, sym, idx


def lane_decode_case(n, dev):
    """(args, symbols, stream, host encode s) for kernel B2 on an n-symbol
    lane_inputs slice, its banks bucketed as the codec buckets them."""
    import torch

    from stf_tpu_torch.ans import lane_coder as lc
    from stf_tpu_torch.models.codec import _bucket

    tables, sym, idx = lane_inputs(n)
    t0 = time.perf_counter()
    stream = lc.lane_encode(sym, idx, tables)
    enc_s = time.perf_counter() - t0
    (stream,) = lc.unpack_lane_stream(lc.pack_lane_stream([stream]))
    wr = _bucket(lc.words_rows_for(stream.word_counts.max()))
    sr = _bucket(lc.side_rows_for(stream.side_counts.max()))
    args = (
        torch.from_numpy(idx).to(dev),
        torch.from_numpy(lc.pack_word_banks(stream, wr)).to(dev),
        torch.from_numpy(lc.pad_side_banks(stream, sr)).to(dev),
        lc.states_tensor(stream, dev),
        *lc.table_tensors(tables, dev),
        n,
    )
    return args, sym, stream, enc_s


def phase_lane_decode(dev, sm_mhz):
    """B2 vs its plain version and the encoded symbols at the main path's
    shape and at 1,179,648 symbols; the kernels row is the main path's."""
    import numpy as np
    import torch

    from stf_tpu_torch.ans import lane_coder as lc

    rows = []
    for n, iters in ((LANE_MAIN_N, 50), (LANE_BIG_N, 10)):
        args, sym, stream, enc_s = lane_decode_case(n, dev)
        out = lc.lane_decode(*args)
        plain = lc.lane_decode_plain(*args)
        torch.cuda.synchronize()
        got = out.cpu().numpy()
        if not np.array_equal(got, sym):
            raise AssertionError(f"B2 n={n}: decode differs from the encoded "
                                 f"symbols at {int((got != sym).sum())} of {n}")
        if not np.array_equal(plain.cpu().numpy(), sym):
            raise AssertionError(f"B2 n={n}: plain version differs from the "
                                 f"encoded symbols")
        ms = graph_ms(lambda: lc.lane_decode(*args), iters)
        eager_ms = cuda_ms(lambda: lc.lane_decode(*args), 20)
        plain_ms = cuda_ms(lambda: lc.lane_decode_plain(*args), 1)
        stream_bytes = (2 * int(stream.word_counts.sum())
                        + 4 * int(stream.side_counts.sum()))
        nbytes = 8 * n + stream_bytes + 4 * stream.states.size + 4 * args[4].numel()
        # ~30 integer operations per symbol: 7-step search, update, renorm, ranks
        bound_ms, bound_by = bound(nbytes, 30 * n)
        tg = lc.rows_per_group(n)
        floor_ms, formula = lane_decode_floor(tg, args[4].shape[1], sm_mhz)
        print(f"B2 lane_decode: n {n} escapes {int(stream.side_counts.sum())} "
              f"stream {stream_bytes} B (host encode {enc_s:.3f} s) exact; "
              f"kernel {ms:.4f} ms (eager per call {eager_ms:.4f} ms) plain "
              f"{plain_ms:.2f} ms bound {bound_ms:.4f} ms ({bound_by}); chain "
              f"floor {floor_ms:.4f} ms = {formula}")
        if n == LANE_MAIN_N:
            rows.append(dict(
                name="lane_decode", route="cuda",
                source="stf_tpu_torch/csrc/lane_decode.cu",
                replaces="stf_tpu/ans/lane_coder.py:495",
                launches=None, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            ))
    return rows


def phase_lane_encode(dev, sm_mhz):
    """B3 vs its plain version and the native host encoder at the main
    path's shape and at 1,179,648 symbols; the kernels row is the main
    path's."""
    import numpy as np
    import torch

    from stf_tpu_torch.ans import lane_coder as lc

    rows = []
    for n, iters in ((LANE_MAIN_N, 50), (LANE_BIG_N, 10)):
        tables, sym, idx = lane_inputs(n)
        G, K = lc.GROUPS, lc.K
        t0 = time.perf_counter()
        want = lc.lane_encode(sym, idx, tables)
        host_s = time.perf_counter() - t0
        args = (
            torch.from_numpy(sym).to(dev), torch.from_numpy(idx).to(dev),
            *lc.table_tensors(tables, dev), n, int(tables.offsets[0]),
        )
        out = lc.lane_encode_device(*args)
        plain = lc.lane_encode_device_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("words", "side", "states", "counts"), out, plain):
            if not torch.equal(a, b):
                raise AssertionError(f"B3 n={n}: {name} differs from the plain version")
        words, side, states, counts = (a.cpu().numpy() for a in out)
        if counts[:, 2].any():
            raise AssertionError(f"B3 n={n}: side overflow flags {counts[:, 2].tolist()}")
        tg, wcap_rows, scap_rows = lc.encode_caps(n)
        got = lc.assemble_from_tails(
            words.reshape(G, wcap_rows, K)[:, :tg], side.reshape(G, scap_rows, K),
            states, counts, n,
        )
        for field in lc.LaneStream._fields:
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"B3 n={n}: stream {field} differs from "
                                     f"lane_encode's")
        ms = graph_ms(lambda: lc.lane_encode_device(*args), iters)
        eager_ms = cuda_ms(lambda: lc.lane_encode_device(*args), 20)
        plain_ms = cuda_ms(lambda: lc.lane_encode_device_plain(*args), 1)
        # symbols and indexes in, the four outputs (int32 cells) out
        nbytes = 8 * n + 4 * tables.cdf.size + 4 * (
            words.size + side.size + states.size + counts.size
        )
        # ~40 integer operations per symbol over the two passes
        bound_ms, bound_by = bound(nbytes, 40 * n)
        floor_ms, formula = lane_encode_floor(tg, sm_mhz)
        stream_bytes = 2 * int(got.word_counts.sum()) + 4 * int(got.side_counts.sum())
        print(f"B3 lane_encode: n {n} escapes {int(got.side_counts.sum())} stream "
              f"{stream_bytes} B, identical to the host encoder's; kernel "
              f"{ms:.4f} ms (eager per call {eager_ms:.4f} ms) plain "
              f"{plain_ms:.2f} ms host encode {host_s:.3f} s bound "
              f"{bound_ms:.4f} ms ({bound_by}); chain floor {floor_ms:.4f} ms "
              f"= {formula}; overflow flags {counts[:, 2].tolist()}")
        if n == LANE_MAIN_N:
            rows.append(dict(
                name="lane_encode", route="cuda",
                source="stf_tpu_torch/csrc/lane_encode.cu",
                replaces="stf_tpu/ans/lane_coder.py:801",
                launches=None, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            ))
    return rows


def phase_layout_pin(dev):
    """B4 against its plain version on each of its paths, and timed beside
    PyTorch's copy on the fused decode's operands. Each main-path path
    gets one kernels row, timed on the operand that takes it most often
    (packed: mu, like y_prev; transpose: rv); lm (packed, 3.9 MB), z_hat
    (transpose) and a cropped lm (general; no pin of the decode is a crop)
    are timed and printed."""
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.ans import lane_coder as lc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    u8 = lambda *s: torch.randint(  # noqa: E731
        0, 256, s, device=dev, generator=gen, dtype=torch.int32).to(torch.uint8)
    rv = torch.randint(-99, 99, (BATCH, 32, 48, 32), device=dev, generator=gen,
                       dtype=torch.int32)
    # (kernels row or None, operand, view, the path pin_plan must pick);
    # the timed ones first
    cases = [
        ("layout_pin_packed", "mu (2,32,32,48) f32 packed",
         randn(BATCH, 32, 32, 48), "packed"),
        (None, "lm (2,320,32,48) f32 packed", randn(BATCH, 320, 32, 48),
         "packed"),
        ("layout_pin_transpose", "rv (2,32,32,48) i32 NHWC as NCHW",
         rv.permute(0, 3, 1, 2), "transpose"),
        (None, "z_hat (2,192,8,12) f32 NHWC as NCHW",
         randn(BATCH, 8, 12, 192).permute(0, 3, 1, 2), "transpose"),
        (None, "lm (2,320,32,48) f32 cropped from (2,320,36,52)",
         randn(BATCH, 320, 36, 52)[:, :, :32, :48], "general"),
        (None, "(3,7,11,5) uint8", u8(3, 7, 11, 5), "packed"),
        (None, "(13,128) bf16 cropped", randn(13, 129).to(torch.bfloat16)[:, 1:],
         "general"),
        (None, "(5,77) uint8 NHWC as NCHW", u8(5, 7, 11, 3).permute(0, 3, 1, 2),
         "transpose"),
        (None, "(3,4,5) f32 stride 0", randn(3, 1, 5).expand(3, 4, 5), "general"),
        (None, "(999,) f32 misaligned", randn(1000)[1:], "packed"),
    ]
    counts = _native.launch_counts
    for _, what, x, kind in cases:
        before = counts[f"layout_pin_{kind}"]
        got = lc.layout_pin(x)
        want = lc.layout_pin_plain(x)
        torch.cuda.synchronize()
        if counts[f"layout_pin_{kind}"] != before + 1:
            plan = lc.pin_plan(x.shape, x.stride(), x.element_size(), x.data_ptr())
            raise AssertionError(f"B4 {what}: took {plan.kind}, want {kind}")
        if not (got.is_contiguous() and torch.equal(
                got.view(torch.uint8), want.view(torch.uint8))):
            raise AssertionError(f"B4 {what}: bytes differ from the plain version")
    rows = []
    for name, what, x, kind in cases[:5]:
        # x.contiguous() of a packed tensor is x itself: clone() copies
        lib_name = "clone" if x.is_contiguous() else "contiguous"
        ms = graph_ms(lambda: lc.layout_pin(x), 100)
        eager_ms = cuda_ms(lambda: lc.layout_pin(x), 200)
        plain_ms = graph_ms(lambda: lc.layout_pin_plain(x), 100)
        lib_ms = graph_ms(getattr(x, lib_name), 100)
        bound_ms, bound_by = bound(2 * x.numel() * x.element_size(), 0)
        print(f"B4 layout_pin {kind}: {what} kernel {ms:.4f} ms (eager per "
              f"call {eager_ms:.4f} ms) plain {plain_ms:.4f} ms {lib_name}() "
              f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x) bound {bound_ms:.4f} ms "
              f"({bound_by})" + ("" if kind != "general"
                                 else "; not on the main path"))
        if name:
            rows.append(dict(
                name=name, route="cuda",
                source="stf_tpu_torch/csrc/layout_pin.cu",
                replaces="stf_tpu/ans/lane_coder.py:706",
                launches=None, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            ))
    print(f"B4 layout_pin: {len(cases)} views bit-exact, each on its path")
    return rows


def conv_f64_errors(x, w, b):
    """(kernel, cuDNN f32) largest absolute error against an f64
    convolution, on the first two images of x."""
    import torch.nn.functional as F

    from stf_tpu_torch.layers import conv_core

    x = x[:2]
    pad = w.shape[-1] // 2
    want = F.conv2d(x.double(), w.double(), b.double(), padding=pad)
    got = conv_core.conv2d_tc(x, w, b)
    lib = F.conv2d(x, w, b, padding=pad)
    return ((got.double() - want).abs().max().item(),
            (lib.double() - want).abs().max().item())


def phase_conv(dev):
    """The 3xTF32 convolution at CONV_SHAPES and its transposed
    convolution at DECONV_SHAPES (module docstring, 6b): checks first,
    then times; returns its kernels rows."""
    import torch
    import torch.nn.functional as F

    from stf_tpu_torch.layers import conv_core
    from stf_tpu_torch.utils.numerics import use_numerical_policy

    use_numerical_policy()  # cuDNN as the codec runs it: the yardstick
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, seen = [], set()
    for label, ci, co, k, h, w, batch in CONV_SHAPES:
        x = torch.randn(batch, ci, h, w, device=dev, generator=gen)
        wt = torch.randn(co, ci, k, k, device=dev, generator=gen) / (
            ci * k * k) ** 0.5
        b = torch.randn(co, device=dev, generator=gen)
        err, lib_err = conv_f64_errors(x, wt, b)
        wp = conv_core.pack_weight(wt)
        if not torch.equal(wp, conv_core.pack_weight_plain(wt)):
            raise AssertionError(f"conv_tc {label}: packed weights differ")
        y = conv_core.conv2d_tc(x, wt, b, packed=wp)
        if err > CONV_TOL * lib_err or not torch.equal(
                y, conv_core.conv2d_tc(x, wt, b)):
            raise AssertionError(f"conv_tc {label}: f64 error {err:.3g} "
                                 f"(cuDNN f32 {lib_err:.3g}) or launches differ")
        for i in (0, batch - 1):
            if not torch.equal(conv_core.conv2d_tc(x[i:i + 1], wt, b),
                               y[i:i + 1]):
                raise AssertionError(f"conv_tc {label}: image {i} alone differs")
        M = batch * h * w
        split = conv_core.splits(ci, k)
        chosen = conv_core.tile_config(M, co, split, sms)
        times = {}
        for c in range(len(conv_core.CONFIGS)):
            if not torch.equal(conv_core.conv2d_tc(x, wt, b, config=c,
                                                   packed=wp), y):
                raise AssertionError(f"conv_tc {label}: configuration {c} differs")
            times[c] = graph_ms(lambda c=c: conv_core.conv2d_tc(
                x, wt, b, config=c, packed=wp), 5, 3)
        ms = times[chosen]
        eager_ms = cuda_ms(lambda: conv_core.conv2d_tc(x, wt, b, packed=wp), 10)
        pack_ms = graph_ms(lambda: conv_core.pack_weight(wt), 20, 3)
        lib_ms = graph_ms(lambda: F.conv2d(x, wt, b, padding=k // 2), 5, 3)
        plain_ms = graph_ms(lambda: conv_core.conv2d_tc_plain(x, wt, b), 3, 2)
        flops = 2 * M * co * ci * k * k
        nbytes = 4 * (x.numel() + wt.numel() + b.numel() + M * co)
        bound_ms, bound_by = bound(nbytes, flops, TF32X3_OPS_PER_S)
        print(f"conv_tc {label} batch {batch} (M {M}, N {co}, K {ci * k * k}, "
              f"split {split}): kernel {ms:.4f} ms = {flops / ms / 1e9:.1f} "
              f"TFLOP/s (eager per call {eager_ms:.4f} ms; weight packing "
              f"{pack_ms:.4f} ms), configuration {chosen} of "
              + ", ".join(f"{c}: {t:.4f}" for c, t in times.items())
              + f"; cuDNN F.conv2d {lib_ms:.4f} ms = {flops / lib_ms / 1e9:.1f} "
              f"TFLOP/s ({lib_ms / ms:.2f}x); plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%); "
              f"f64 error {err:.3g} (cuDNN f32 {lib_err:.3g})")
        key = (k, batch == 1)
        if key not in seen:
            seen.add(key)
            rows.append(dict(
                name=conv_core.launch_key(k), route="cuda",
                source="stf_tpu_torch/csrc/conv_tc.cu", replaces=None,
                shape=f"{label} batch {batch}", launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms,
                path="stf" if k == 5 else "cnn"))
    return rows + phase_deconv(dev, gen, sms)


def phase_deconv(dev, gen, sms):
    """The kernel's transposed convolution at DECONV_SHAPES (module
    docstring, 6b): its packing the plain version's, its largest error
    against an f64 transposed convolution no more than DECONV_TOL x cuDNN
    f32's, each image alone and every tile configuration bit-equal to the
    batch's outputs; timed over graph replays in the form `deconv_joint`
    picks and in the other, beside the plain version and cuDNN's
    F.conv_transpose2d, with the bound. Returns its kernels rows."""
    import torch
    import torch.nn.functional as F

    from stf_tpu_torch.layers import conv_core

    def lib(x, w, b):
        return F.conv_transpose2d(x, w, b, stride=2, padding=2,
                                  output_padding=1)

    rows, seen = [], set()
    for label, ci, co, h, w, batch in DECONV_SHAPES:
        x = torch.randn(batch, ci, h, w, device=dev, generator=gen)
        wt = torch.randn(ci, co, 5, 5, device=dev, generator=gen) / (
            co * 25) ** 0.5
        b = torch.randn(co, device=dev, generator=gen)
        joint = conv_core.deconv_joint(co)
        wp = conv_core.deconv_pack_weight(wt)
        kernels = ([conv_core.joint_kernel(wt)] if joint
                   else conv_core.phase_kernels(wt))
        if not torch.equal(wp, torch.cat([
                conv_core.pack_weight_plain(k, round_small=True).reshape(-1)
                for k in kernels])):
            raise AssertionError(f"conv_tc {label}: packed weights differ")
        y = conv_core.conv_transpose2d_tc(x, wt, b, packed=wp)
        two = (x[:2], wt, b)
        want = lib(*(t.double() for t in two))
        err = (y[:2].double() - want).abs().max().item()
        lib_err = (lib(*two).double() - want).abs().max().item()
        del want
        if err > DECONV_TOL * lib_err:
            raise AssertionError(f"conv_tc {label}: f64 error {err:.3g} "
                                 f"(cuDNN f32 {lib_err:.3g})")
        for i in (0, batch - 1):
            if not torch.equal(conv_core.conv_transpose2d_tc(
                    x[i:i + 1], wt, b, packed=wp), y[i:i + 1]):
                raise AssertionError(f"conv_tc {label}: image {i} alone differs")
        for c in range(len(conv_core.CONFIGS)):
            if not torch.equal(conv_core.conv_transpose2d_tc(
                    x, wt, b, config=c, packed=wp), y):
                raise AssertionError(f"conv_tc {label}: configuration {c} differs")
        M = batch * h * w
        split = conv_core.splits(ci, 3)
        chosen = (conv_core.tile_config(M, 4 * co, split, sms) if joint
                  else conv_core.tile_config(M, co, split, sms, gemms=4))
        iters = 5 if batch == 1 else 3
        ms = graph_ms(lambda: conv_core.conv_transpose2d_tc(
            x, wt, b, packed=wp), iters, 3)
        other_wp = conv_core.deconv_pack_weight(wt, joint=not joint)
        other_ms = graph_ms(lambda: conv_core.conv_transpose2d_tc(
            x, wt, b, packed=other_wp, joint=not joint), iters, 3)
        eager_ms = cuda_ms(lambda: conv_core.conv_transpose2d_tc(
            x, wt, b, packed=wp), 10)
        lib_ms = graph_ms(lambda: lib(x, wt, b), iters, 3)
        plain_ms = graph_ms(lambda: conv_core.conv_transpose2d_tc_plain(
            x, wt, b), 2, 2)
        flops = 2 * M * ci * co * 25
        nbytes = 4 * (x.numel() + wt.numel() + b.numel() + 4 * M * co)
        bound_ms, bound_by = bound(nbytes, flops, TF32X3_OPS_PER_S)
        form = "joint" if joint else "phases"
        print(f"conv_tc {label} batch {batch} ({form}, configuration "
              f"{chosen}, split {split}): kernel {ms:.4f} ms = "
              f"{flops / ms / 1e9:.1f} TFLOP/s (eager per call {eager_ms:.4f} "
              f"ms; the other form {other_ms:.4f} ms); cuDNN "
              f"F.conv_transpose2d {lib_ms:.4f} ms = "
              f"{flops / lib_ms / 1e9:.1f} TFLOP/s ({lib_ms / ms:.2f}x); "
              f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}%); f64 error {err:.3g} (cuDNN f32 "
              f"{lib_err:.3g})")
        if (joint, batch) not in seen:
            seen.add((joint, batch))
            rows.append(dict(
                name=conv_core.deconv_launch_key(joint), route="cuda",
                source="stf_tpu_torch/csrc/conv_tc.cu", replaces=None,
                shape=f"{label} batch {batch}", launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, path="cnn"))
    return rows


def host_lane_stream(codec, enc):
    """The lane y-stream the native host encoder makes from a compress's
    symbols and indexes: header, index hashes, packed segments."""
    import numpy as np

    from stf_tpu_torch.ans import lane_coder as lc
    from stf_tpu_torch.models.codec import _LANE_HEADER_MAGIC, idx_hash

    flat = lambda t: t.cpu().numpy().reshape(-1)  # noqa: E731
    hashes = [int(idx_hash(i.reshape(-1))) for i in enc["indexes"]]
    return (
        np.asarray([_LANE_HEADER_MAGIC] + hashes, "<u4").tobytes()
        + lc.pack_lane_stream([
            lc.lane_encode(flat(s), flat(i), codec.lane_tables)
            for s, i in zip(enc["symbols"], enc["indexes"])
        ])
    )


def smoke_model(name):
    """The full-width registry model `name` with weights drawn from SEED.
    For "stf" and "dystf" (the same slice stacks and hyper synthesis) the
    scale stacks' last bias is lifted by 1 (SCALE_LIFT): STF's seed weights
    put every predicted scale at the table's floor (index 0, 0.11) while
    y - mu spreads with std ~0.8, so at 512x768 one lane group of one
    slice escapes past B3's side channel (~1/8 of its symbols) and the
    port's fused encode tiers code that call through the per-slice walk
    (`phase_stf_seed_fallback` checks that path): the tiers' own graphs
    would not be checked. A trained model predicts scales near y's
    spread; the lift puts these at ~1, table index 18-19. CC_GD's gates
    are drawn from U(0.5, 1.5) and its masks from Bernoulli(2/3), so that
    they zero about a third of each gated layer's channels (at their init
    of ones a gate read from the wrong index would go unseen)."""
    import torch

    from stf_tpu_torch.models.cc_gd import GateDecorator
    from stf_tpu_torch.zoo import create_model

    model = create_model(name, seed=SEED)
    with torch.no_grad():
        if name in SCALE_LIFT:
            for stack in model.cc_scale_transforms:
                stack[-1].bias += SCALE_LIFT[name]
        gen = torch.Generator().manual_seed(SEED)
        for m in model.modules():
            if isinstance(m, GateDecorator):
                m.gate.copy_(torch.rand(m.gate.shape, generator=gen) + 0.5)
                m.mask.copy_((torch.rand(m.mask.shape, generator=gen)
                              < 2 / 3).float())
    return model


def strict(fn, *a):
    """fn(*a) with warnings as errors: a hash fallback or a tier's demotion
    fails the smoke."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return fn(*a)


def timed(fn, *a):
    """(fn(*a), its synchronised wall seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def warm_medians(fns, n=5):
    """{name: median seconds of n synchronised calls}."""
    import numpy as np

    return {what: float(np.median([timed(fn)[1] for _ in range(n)]))
            for what, fn in fns.items()}


@contextlib.contextmanager
def window_head_design():
    """Every B1 launch inside takes the window-head design (one block per
    (window, head): PR 13's at TBC's 8x8 geometries), as `main_design`
    chose before the head-group design; CUDA graphs captured earlier keep
    the kernels they captured."""
    import torch

    from stf_tpu_torch.layers import attention_core as ac

    main = ac.main_design
    ac.main_design = lambda ws, hd, nh, dtype, group: (  # noqa: E731
        "bf16_mma" if dtype == torch.bfloat16 else "window_head")
    try:
        yield
    finally:
        ac.main_design = main


def designs_in_turns(calls):
    """{name: (window-head median s, head-group median s)} of warm
    synchronised calls, medians of 5 taken in turns: window-head,
    head-group, head-group, window-head, so that drift shows in neither."""
    import numpy as np

    old, new = {k: [] for k in calls}, {k: [] for k in calls}
    for turn in (old, new, new, old):
        for what, fn in calls.items():
            if turn is old:
                with window_head_design():
                    turn[what] += [timed(fn)[1] for _ in range(5)]
            else:
                turn[what] += [timed(fn)[1] for _ in range(5)]
    return {k: (float(np.median(old[k])), float(np.median(new[k])))
            for k in calls}


def tier_designs_in_turns(tag, model, x, dev, smi, tier, **codec_kw):
    """The full fused tier of `model` with B1's window-head design against
    `tier` (the same tier, captured with the head-group design), both
    graph replays: a second codec captures its compress and decompress
    graphs under `window_head_design`, then each codec's warm compress and
    fused decompress are timed in turns (window-head, head-group,
    head-group, window-head; medians of 10), and one warm call each is
    profiled for its device-busy time. Each codec's stream decodes to its
    own symbols."""
    import numpy as np
    import torch

    from stf_tpu_torch.models import Codec

    with window_head_design():
        old = Codec(model, coder="lane", device=dev, fused_encode=True,
                    **codec_kw)
        enc_old = strict(old.compress, x)
        strict(old.decompress, enc_old["strings"], enc_old["shape"])
    enc_new = strict(tier.compress, x)
    for codec, enc in ((old, enc_old), (tier, enc_new)):
        dec = strict(codec.decompress, enc["strings"], enc["shape"])
        if not all(torch.equal(a, b) for a, b in zip(enc["symbols"],
                                                     dec["symbols"])):
            raise AssertionError(f"{tag}: a design's tier stream does not "
                                 "decode to its symbols")
    calls = {}
    for name, codec, enc in (("window-head", old, enc_old),
                             ("head-group", tier, enc_new)):
        calls[name] = (
            lambda c=codec: strict(c.compress, x),
            lambda c=codec, e=enc: strict(c.decompress, e["strings"],
                                          e["shape"]))
    secs = {k: ([], []) for k in calls}
    for turn in ("window-head", "head-group", "head-group", "window-head"):
        for j in range(2):
            secs[turn][j].extend(timed(calls[turn][j])[1] for _ in range(5))
    med = {k: [float(np.median(v)) for v in secs[k]] for k in calls}
    busy = {k: [profile_call(fn, f"{tag} {k}")[1] for fn in calls[k]]
            for k in calls}
    (oc, od), (nc, nd) = med["window-head"], med["head-group"]
    print(f"{tag} full tier, B1 designs in turns ({smi}; graph replays, "
          f"medians of 10): compress window-head {oc * 1e3:.3f} ms, "
          f"head-group {nc * 1e3:.3f} ms ({oc / nc:.3f}x); fused decompress "
          f"window-head {od * 1e3:.3f} ms, head-group {nd * 1e3:.3f} ms "
          f"({od / nd:.3f}x); device busy, one profiled call: compress "
          f"{busy['window-head'][0] * 1e3:.3f} / "
          f"{busy['head-group'][0] * 1e3:.3f} ms, decompress "
          f"{busy['window-head'][1] * 1e3:.3f} / "
          f"{busy['head-group'][1] * 1e3:.3f} ms")


def per_slice_decompress(codec, enc):
    """`codec`'s decompress of `enc` through the per-slice walk."""
    codec.fused = False
    try:
        return codec.decompress(enc["strings"], enc["shape"])
    finally:
        codec.fused = True


def b1_launches(d):
    """B1's launches, all instances, in a launch-count dict."""
    return sum(v for k, v in d.items() if k.startswith("window_attention"))


class StepRecorder:
    """Runs the steps of a path: each strict, timed, with the kernel
    launches it made kept in `steps[step]` and its seconds in
    `secs[step]`."""

    def __init__(self):
        self.steps, self.secs = {}, {}

    def __call__(self, step, fn, *a):
        from stf_tpu_torch import _native

        counts = _native.launch_counts
        snap = dict(counts)
        out, self.secs[step] = timed(strict, fn, *a)
        self.steps[step] = {k: v - snap.get(k, 0) for k, v in counts.items()
                            if v - snap.get(k, 0)}
        return out


FUSED_FIRST = "fused decompress, first: warm-up + capture + replay"
FUSED = "fused decompress (replay)"
PER_SLICE = "per-slice decompress"


def codec_round_trip(tag, model, dev, x, b1_calls):
    """`model` through the lane coder (B3 encode; fused decompress, its
    first call and a replay; per-slice decompress) and the host coder on
    the uint8 batch `x`, every step strict (`StepRecorder`): symbols round
    trip, the four x_hat bit-equal, finite and of x's shape, and each
    step's B1/B2/B3/B4 launches the path's (`b1_calls`: B1's launches in
    a compress and in a decompress; the fused first call runs its walk
    eagerly, then captures and replays it, so it counts twice), B4's by
    path too. Counts are set to 0 before the path; `launches` is read
    after it. Returns a namespace: launches, the recorder `run` (its steps
    and secs), the lane codec, enc, the decodes first, fused, walk, and
    the host coder's henc, hdec."""
    from types import SimpleNamespace

    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.models import Codec

    counts = _native.launch_counts
    lane = Codec(model, coder="lane", device=dev)
    host = Codec(model, coder="host", device=dev)
    S = model.num_slices
    E, D = b1_calls
    pins = 3 * S + 2  # B4 launches in a fused walk
    run = StepRecorder()

    counts.clear()  # the path starts here
    enc = run("lane compress", lane.compress, x)
    first = run(FUSED_FIRST, lane.decompress, enc["strings"], enc["shape"])
    fused = run(FUSED, lane.decompress, enc["strings"], enc["shape"])
    walk = run(PER_SLICE, per_slice_decompress, lane, enc)
    henc = run("host compress", host.compress, x)
    hdec = run("host decompress", host.decompress, henc["strings"],
               henc["shape"])
    launches = dict(counts)  # the path ends here
    for what, d in (("fused first", first), ("fused", fused),
                    ("per-slice", walk), ("host", hdec)):
        ref = henc if what == "host" else enc
        if not all(torch.equal(a, b) for a, b in zip(ref["symbols"],
                                                    d["symbols"])):
            raise AssertionError(f"{tag} {what}: decoded symbols differ")
        if not torch.equal(d["x_hat"], hdec["x_hat"]):
            raise AssertionError(f"{tag} {what}: x_hat is not bit-equal to "
                                 "the host coder's")
    if not all(torch.equal(a, b) for a, b in zip(enc["symbols"],
                                                henc["symbols"])):
        raise AssertionError(f"{tag}: lane and host quantized other symbols")
    x_hat = hdec["x_hat"]
    if x_hat.shape != tuple(x.shape) or not torch.isfinite(x_hat).all():
        raise AssertionError(f"{tag}: x_hat {tuple(x_hat.shape)} or its "
                             "values bad")
    want = {"lane compress": (E, 0, S, 0),
            FUSED_FIRST: (2 * D, 2 * S, 0, 2 * pins),
            FUSED: (D, S, 0, pins),
            PER_SLICE: (D, S, 0, 0),
            "host compress": (E, 0, 0, 0), "host decompress": (D, 0, 0, 0)}
    for step, expect in want.items():
        d = run.steps[step]
        got = (b1_launches(d), d.get("lane_decode", 0),
               d.get("lane_encode", 0), d.get("layout_pin", 0))
        if got != expect:
            raise AssertionError(f"{tag} {step}: B1/B2/B3/B4 launches {got}, "
                                 f"want {expect}")
    # B4's 3S + 2 pins per fused walk by path: z_hat and the S rv are NHWC
    # views (transpose); lm, ls, every mu and the S - 1 y_prev are packed
    for step, reps in ((FUSED_FIRST, 2), (FUSED, 1)):
        check_pins(tag, step, run.steps[step], reps, S)
    print(f"{tag} through the lane coder (fused and per-slice decompress) "
          f"and the host coder ({tuple(x.shape)}): symbols round trip, x_hat "
          f"bit-equal, {enc['host_encoded']} of {S} B3 segments sent to the "
          f"host encoder; B1/B2/B3/B4 launches as the path's: "
          + "; ".join(f"{k} {v}" for k, v in want.items()))
    return SimpleNamespace(launches=launches, run=run, lane=lane, enc=enc,
                           first=first, fused=fused, walk=walk, henc=henc,
                           hdec=hdec)


def check_pins(tag, step, d, reps, S):
    """B4's launches by path in `d`, a step of `reps` fused walks over S
    slices: reps * (2S + 1) packed, reps * (S + 1) transposed."""
    from stf_tpu_torch.ans import lane_coder as lc

    got = {k: d.get(f"layout_pin_{k}", 0) for k in lc.PIN_KINDS}
    want = {"packed": reps * (2 * S + 1), "transpose": reps * (S + 1),
            "general": 0}
    print(f"{tag}: B4 pins by path in {step}: {got}")
    if got != want:
        raise AssertionError(f"{tag} {step}: B4 pins by path {got}, want "
                             f"{want}")


def phase_codec(dev, smi, name):
    """A main path: the full-width registry model `name` (one of
    CODEC_MODELS) through `codec_round_trip` (lane coder: B3 encode, fused
    and per-slice decompress; host coder), then the two fused encode
    tiers' round trips on top. Returns the kernel launches of the path."""
    import numpy as np
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.utils import psnr

    x = (smooth_batch(BATCH, HEIGHT, WIDTH, SEED) * 255).round().astype(np.uint8)
    model = smoke_model(name)
    tiers = {"full": Codec(model, coder="lane", device=dev, fused_encode=True),
             "split": Codec(model, coder="lane", device=dev,
                            fused_encode="split")}
    counts = _native.launch_counts
    S = model.num_slices
    # B1 launches in an analysis, a hyper synthesis and a synthesis; a
    # compress runs E of them, a decompress D
    an, hy, sy = B1_CALLS[name]
    E, D = an + hy, hy + sy
    pins = 3 * S + 2  # B4 launches in a fused walk

    # this model's main path starts here: the round trip sets the counts to 0
    rt = codec_round_trip(name, model, dev, x, (E, D))
    lane, enc, run = rt.lane, rt.enc, rt.run
    tier_steps = {}
    for tier, codec in tiers.items():
        steps_of = (f"{tier}-tier compress, first: warm-up + capture + replay "
                    "+ self-check", f"{tier}-tier compress (replay)",
                    f"fused decompress of the {tier}-tier stream (replay)")
        first_enc = run(steps_of[0], codec.compress, x)
        tenc = run(steps_of[1], codec.compress, x)
        tdec = run(steps_of[2], codec.decompress, tenc["strings"],
                   tenc["shape"])
        tier_steps[tier] = steps_of, first_enc, tenc, tdec
    launches = dict(counts)  # this model's main path ends here
    for step, d in run.steps.items():
        print(f"{name}: launches in {step}: {d}")

    t0 = time.perf_counter()
    if enc["strings"][0][0] != host_lane_stream(lane, enc):
        raise AssertionError(f"{name}: B3-encoded y-stream differs from the host lane encoder's")
    host_lane_s = time.perf_counter() - t0
    if rt.henc["strings"][1] != enc["strings"][1]:
        raise AssertionError(f"{name}: lane and host codecs wrote different z strings")
    if enc["host_encoded"] == S:
        raise AssertionError(f"{name}: every B3-encoded segment overflowed to the host")
    if len(lane._graphs) != 1:
        raise AssertionError(f"{name}: {len(lane._graphs)} fused graphs for one geometry")
    y_want = enc["strings"][0][0]
    for tier, (_, first_enc, tenc, tdec) in tier_steps.items():
        codec = tiers[tier]
        if codec._fused_mode != tier or not codec.fused_encode:
            raise AssertionError(f"{name} {tier} tier demoted to {codec._fused_mode} "
                                 f"(fused_encode {codec.fused_encode})")
        for e in (first_enc, tenc):
            y = e["strings"][0][0]
            if y[0] != y_want[0] | 1 or y[1:] != y_want[1:]:
                raise AssertionError(
                    f"{name} {tier} tier: y-stream is not the per-slice "
                    "stream with the fused flag (B3 segments the per-slice "
                    f"compress sent to the host encoder: {enc['host_encoded']} "
                    f"of {S})")
            if e["strings"][1] != enc["strings"][1]:
                raise AssertionError(f"{name} {tier} tier: z strings differ")
            if not all(torch.equal(a, b) for a, b in
                       zip(e["symbols"] + e["indexes"],
                           enc["symbols"] + enc["indexes"])):
                raise AssertionError(f"{name} {tier} tier: symbols or indexes differ")
        if not torch.equal(tdec["x_hat"], rt.first["x_hat"]):
            raise AssertionError(f"{name} {tier} tier: decoded x_hat differs")
        if len(codec._enc_graphs) != 1 or len(codec._graphs) != 1:
            raise AssertionError(f"{name} {tier} tier: {len(codec._enc_graphs)} encode "
                                 f"and {len(codec._graphs)} decode graphs")
    x_hat = rt.first["x_hat"]
    # the decoded image against the model's own eval forward on x
    xf = torch.from_numpy(x).to(dev).float() / 255.0
    with torch.inference_mode():
        ref = model(xf)["x_hat"].clamp(0, 1)
    fwd_err = (ref - x_hat).abs().max().item()
    if not fwd_err <= 1e-3:
        raise AssertionError(f"{name}: codec x_hat vs eval forward: {fwd_err}")

    # (step, B1, B2, B3, B4) launches each tier step must show. A tier's
    # first compress runs its walk eagerly (warm-up), captures it (counts
    # taken back) and replays it, then its self-check's fused decompress
    # does the same (B1 E + E and D + D, B2 S + S, B4 pins + pins); the
    # split tier's analysis and hyper synthesis run eagerly once a call
    # (B1 E). Neither tier's walk pins.
    (full_first, full_replay, full_dec), _, _, _ = tier_steps["full"]
    (split_first, split_replay, split_dec), _, _, _ = tier_steps["split"]
    want = (
        (full_first, 2 * E + 2 * D, 2 * S, 2 * S, 2 * pins),
        (full_replay, E, 0, S, 0),
        (full_dec, D, S, 0, pins),
        (split_first, E + 2 * D, 2 * S, 2 * S, 2 * pins),
        (split_replay, E, 0, S, 0),
        (split_dec, D, S, 0, pins),
    )
    for step, *expect in want:
        d = run.steps[step]
        got = [b1_launches(d), d.get("lane_decode", 0),
               d.get("lane_encode", 0), d.get("layout_pin", 0)]
        if got != expect:
            raise AssertionError(f"{name} {step}: B1/B2/B3/B4 launches {got}, "
                                 f"want {expect}")
    # the tiers' stream decodes and self-checks pin as a fused walk does
    for step, reps in ((full_first, 2), (full_dec, 1), (split_first, 2),
                       (split_dec, 1)):
        check_pins(name, step, run.steps[step], reps, S)

    pixels = BATCH * HEIGHT * WIDTH
    lane_bytes = sum(map(len, enc["strings"][0])) + sum(map(len, enc["strings"][1]))
    henc = rt.henc
    host_bytes = sum(map(len, henc["strings"][0])) + sum(map(len, henc["strings"][1]))
    p = psnr(x_hat, xf).item()
    print(f"{name} codec (seed weights, not an operating point): "
          f"{BATCH}x{HEIGHT}x{WIDTH} "
          f"lane {lane_bytes * 8 / pixels:.4f} bpp host {host_bytes * 8 / pixels:.4f} "
          f"bpp PSNR {p:.3f} dB; B3 segments sent to the host encoder: "
          f"{enc['host_encoded']} of {S}; y-stream identical to the host lane "
          f"encoder's (which took {host_lane_s:.3f} s); eval-forward max diff "
          f"{fwd_err:.3g}")
    print(f"{name} first calls: "
          + "; ".join(f"{k} {v:.3f} s" for k, v in run.secs.items()))
    # warm per-call times, medians of 5
    calls = {
        "lane compress (B3, per-slice walk)": lambda: lane.compress(x),
        "full-tier compress": lambda: strict(tiers["full"].compress, x),
        "split-tier compress": lambda: strict(tiers["split"].compress, x),
        "fused decompress": lambda: strict(lane.decompress, enc["strings"],
                                           enc["shape"]),
        "per-slice decompress": lambda: per_slice_decompress(lane, enc),
    }
    warm = warm_medians(calls)
    print(f"{name} warm per call, median of 5 ({smi}): "
          + "; ".join(f"{k} {v * 1e3:.3f} ms" for k, v in warm.items()))
    if name == "tbc":
        print(f"tbc warm per call in PR 13's smokes (ms, medians of 5, H100 "
              f"80GB HBM3 at 700 W): "
              + "; ".join(f"{k} {v}" for k, v in TBC_PR13_MS.items()))
        turns = designs_in_turns({k: calls[k] for k in (
            "lane compress (B3, per-slice walk)", "per-slice decompress")})
        print(f"tbc B1 designs in turns ({smi}; medians of 10): "
              + "; ".join(f"{k} window-head {a * 1e3:.3f} ms, head-group "
                          f"{b * 1e3:.3f} ms ({a / b:.3f}x)"
                          for k, (a, b) in turns.items()))
        tier_designs_in_turns("tbc", model, x, dev, smi, tiers["full"])
    # device-busy share of one warm call each, in a profiler window of its
    # own (the first window, untimed, pays the tracer's start-up)
    profiled = list(calls.items())[:3]
    profile_call(profiled[0][1], "tracer start-up")
    shares = []
    for what, fn in profiled:
        wall, busy, _ = profile_call(fn, what)
        shares.append(f"{what} {wall * 1e3:.3f} ms wall, device busy "
                      f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%)")
    print(f"{name} profiled warm call ({smi}): " + "; ".join(shares))
    return launches


def phase_stf_seed_fallback(dev):
    """The full-width STF as `create_model("stf", seed=SEED)` builds it,
    without `smoke_model`'s lift: a segment of its lane compress
    overflows B3's side channel and goes to the host encoder. Each fused
    encode tier runs its graph, meets the overflow and codes the call
    through the per-slice walk: it must return the per-slice compress's
    stream (without the fused-encode flag), symbols and indexes, with
    host_encoded > 0, and keep its tier. The stream then decodes, fused
    and strict, to the same symbols."""
    import warnings

    import numpy as np
    import torch

    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    x = (smooth_batch(BATCH, HEIGHT, WIDTH, SEED) * 255).round().astype(np.uint8)
    model = create_model("stf", seed=SEED)
    lane = Codec(model, coder="lane", device=dev)
    want = lane.compress(x)
    top = max(int(i.max()) for i in want["indexes"])
    if not want["host_encoded"]:
        raise AssertionError("stf at seed weights: no segment overflowed B3's "
                             "side channel, so smoke_model's lift is not needed")
    for tier in (True, "split"):
        mode = "full" if tier is True else "split"
        codec = Codec(model, coder="lane", device=dev, fused_encode=tier)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = codec.compress(x)
        if got["strings"] != want["strings"] or got["strings"][0][0][0] & 1:
            raise AssertionError(f"stf seed {mode} tier: not the per-slice "
                                 "stream without the fused flag")
        if got["host_encoded"] != want["host_encoded"]:
            raise AssertionError(f"stf seed {mode} tier: host_encoded "
                                 f"{got['host_encoded']}, want {want['host_encoded']}")
        if not all(torch.equal(a, b) for a, b in zip(
                got["symbols"] + got["indexes"], want["symbols"] + want["indexes"])):
            raise AssertionError(f"stf seed {mode} tier: symbols or indexes differ")
        if not codec.fused_encode or codec._fused_mode != mode:
            raise AssertionError(f"stf seed {mode} tier demoted to "
                                 f"{codec._fused_mode} (fused_encode {codec.fused_encode})")
        if len(codec._enc_graphs) != 1:
            raise AssertionError(f"stf seed {mode} tier: {len(codec._enc_graphs)} "
                                 "encode graphs, want 1 (the tier did not run)")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dec = lane.decompress(want["strings"], want["shape"])
    if not all(torch.equal(a, b) for a, b in zip(want["symbols"], dec["symbols"])):
        raise AssertionError("stf seed: the fused decompress gave other symbols")
    print(f"stf at seed weights (no lift; largest scale index {top}): "
          f"{want['host_encoded']} of {model.num_slices} segments overflowed "
          "B3's side channel to the host encoder; both tiers ran their graph "
          "and returned the per-slice stream without the fused flag, "
          "undemoted; it decodes fused to the same symbols")


def phase_tbc_bf16(dev, smi):
    """The full-width TBC through the bf16 codec at batch 2 on the full
    fused encode tier: its analysis (ana and h_a) in bf16, so B1's five
    new bf16 instances run, its hyper synthesis, walk and synthesis in f32.
    The tier's first call (capture and self-check) and a replay, the fused
    and per-slice decompress, and a per-slice bf16 compress: the replay's
    stream is the per-slice one from byte 1 on, symbols round trip, the two
    x_hat bit-equal, no demotion or hash fallback (warnings are errors);
    B1's launches a compress and a decompress by instance are the
    stages' block counts. Prints the PSNR against the f32 codec. Returns
    the path's kernel launches."""
    import numpy as np
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.layers.attention_core import launch_key
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.utils import psnr

    x = (smooth_batch(BATCH, HEIGHT, WIDTH, SEED) * 255).round().astype(np.uint8)
    model = smoke_model("tbc")
    bf16 = dict(device=dev, dtype=torch.bfloat16)
    tier = Codec(model, coder="lane", fused_encode=True, **bf16)
    per_slice = Codec(model, coder="lane", **bf16)
    counts = _native.launch_counts
    run = StepRecorder()
    steps = run.steps

    counts.clear()  # this path starts here
    first = run("full-tier compress, first", tier.compress, x)
    enc = run("full-tier compress (replay)", tier.compress, x)
    dec = run(FUSED, tier.decompress, enc["strings"], enc["shape"])
    wdec = run(PER_SLICE, per_slice_decompress, tier, enc)
    launches = dict(counts)  # this path ends here
    want = run("per-slice compress", per_slice.compress, x)
    for step, d in steps.items():
        print(f"tbc bf16: launches in {step}: {d}")
    if tier._fused_mode != "full" or not tier.fused_encode:
        raise AssertionError("tbc bf16: the full tier was demoted")
    y, y_want = enc["strings"][0][0], want["strings"][0][0]
    if first["strings"] != enc["strings"] or y[0] != y_want[0] | 1 or \
            y[1:] != y_want[1:] or enc["strings"][1] != want["strings"][1]:
        raise AssertionError("tbc bf16: the tier's stream is not the "
                             "per-slice stream with the fused flag")
    for what, d in (("fused", dec), ("per-slice", wdec)):
        if not all(torch.equal(a, b) for a, b in zip(enc["symbols"],
                                                     d["symbols"])):
            raise AssertionError(f"tbc bf16 {what}: decoded symbols differ")
    if not torch.equal(dec["x_hat"], wdec["x_hat"]):
        raise AssertionError("tbc bf16: fused and per-slice x_hat differ")
    # analysis stages 2/2/6/2 blocks at head widths 4/6/8/10, h_a 5 + 1 at
    # 4x4 / 6, the two hyper synthesis stacks 6 each, the synthesis 2/6/2/2
    # at 10/8/6/4
    analysis = {(8, 4): 2, (8, 6): 2, (8, 8): 6, (8, 10): 2, (4, 6): 6}
    bf16_key = lambda g: launch_key(*g, torch.bfloat16)  # noqa: E731
    f32_key = lambda g: launch_key(*g)  # noqa: E731
    compress = {bf16_key(g): n for g, n in analysis.items()}
    compress[f32_key((4, 6))] = 12
    decompress = {f32_key(g): n for g, n in analysis.items()}
    decompress[f32_key((4, 6))] = 12
    for step, expect in (("full-tier compress (replay)", compress),
                         (FUSED, decompress), (PER_SLICE, decompress)):
        got = {k: v for k, v in steps[step].items()
               if k.startswith("window_attention")}
        if got != expect:
            raise AssertionError(f"tbc bf16 {step}: B1 launches {got}, want "
                                 f"{expect}")
    f32 = Codec(model, coder="lane", device=dev)
    f32_enc = f32.compress(x)
    f32_hat = f32.decompress(f32_enc["strings"], f32_enc["shape"])["x_hat"]
    xf = torch.from_numpy(x).to(dev).float() / 255.0
    p16, p32 = psnr(dec["x_hat"], xf).item(), psnr(f32_hat, xf).item()
    turns = designs_in_turns({
        "per-slice bf16 compress": lambda: per_slice.compress(x),
        "per-slice decompress": lambda: per_slice_decompress(tier, enc)})
    print(f"tbc bf16 B1 designs in turns ({smi}; medians of 10): "
          + "; ".join(f"{k} window-head {a * 1e3:.3f} ms, head-group "
                      f"{b * 1e3:.3f} ms ({a / b:.3f}x)"
                      for k, (a, b) in turns.items()))
    tier_designs_in_turns("tbc bf16", model, x, dev, smi, tier,
                          dtype=torch.bfloat16)
    print(f"tbc bf16 round trip ({BATCH}x{HEIGHT}x{WIDTH}, full tier; {smi}): "
          "stream = per-slice stream, symbols round trip, fused = per-slice "
          f"x_hat; B1 a compress {compress}, a decompress {decompress}; PSNR "
          f"to the image bf16 {p16:.4f} dB, f32 {p32:.4f} dB (seed weights)")
    return launches


def phase_codec_bf16(dev, smi, name):
    """The codec as bench.py runs it (`BENCH_CODEC`): the full-width model
    `name` in bf16 on smooth_batch(24, 512, 768, seed=999) through its
    fused encode tier (first call: capture and self-check; then a replay),
    the fused and the per-slice decompress, and the host coder (packed
    drain) at the same options. Decoded symbols must equal the encoded
    ones, the fused and per-slice x_hat and the host coder's must be
    bit-equal, the tier's stream must be a per-slice lane codec's from
    byte 1 on, no tier may be demoted and no hash may fall back (warnings
    are errors); each step's kernel launches must be the path's. Prints
    warm medians of compress and decompress a image, peak memory, the
    device-busy share of a warm compress and decompress, B1's launches a
    call by instance (bf16 in the analysis, f32 in the synthesis), and the
    PSNR of the bf16 x_hat against the f32 codec's at the same weights.
    Returns the path's kernel launches."""
    import numpy as np
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.utils import psnr

    x = (smooth_batch(BENCH_BATCH, HEIGHT, WIDTH, BENCH_SEED) * 255).astype(
        np.uint8)  # as bench.py:304 makes it
    model = smoke_model(name)
    opts = BENCH_CODEC[name]
    bf16 = dict(device=dev, dtype=torch.bfloat16, **opts)
    tier = Codec(model, coder="lane", **bf16)
    host = Codec(model, coder="host", **{**bf16, "fused_encode": False})
    per_slice = Codec(model, coder="lane", **{**bf16, "fused_encode": False})
    counts = _native.launch_counts
    S = model.num_slices
    P = len(tier._sub_batches(BENCH_BATCH))
    chunks = opts.get("analyze_chunks", 1)
    # B1 launches in one analysis (bf16) and one synthesis (f32) of the
    # batch, each run in `chunks` sub-batches
    A = B1_CALLS[name][0] * chunks
    pins = 1 + P * (3 * S + 1)  # B4 launches in a fused walk
    mode = "full" if opts["fused_encode"] is True else "split"

    run = StepRecorder()
    steps, secs = run.steps, run.secs

    first_step, replay_step = (f"{mode}-tier compress, first", f"{mode}-tier "
                               "compress (replay)")
    torch.cuda.reset_peak_memory_stats(dev)
    counts.clear()  # this path starts here
    first = run(first_step, tier.compress, x)
    enc = run(replay_step, tier.compress, x)
    dec = run(FUSED, tier.decompress, enc["strings"], enc["shape"])
    wdec = run(PER_SLICE, per_slice_decompress, tier, enc)
    henc = run("host compress", host.compress, x)
    hdec = run("host decompress", host.decompress, henc["strings"],
               henc["shape"])
    launches = dict(counts)  # this path ends here
    peak = torch.cuda.max_memory_allocated(dev)
    for step, d in steps.items():
        print(f"{name} bf16: launches in {step}: {d}")

    if tier._fused_mode != mode or not tier.fused_encode:
        raise AssertionError(f"{name} bf16: {mode} tier demoted to "
                             f"{tier._fused_mode} (fused_encode "
                             f"{tier.fused_encode})")
    if first["strings"] != enc["strings"]:
        raise AssertionError(f"{name} bf16: the replay wrote another stream")
    want = strict(per_slice.compress, x)
    y, y_want = enc["strings"][0][0], want["strings"][0][0]
    if y[0] != y_want[0] | 1 or y[1:] != y_want[1:] or \
            enc["strings"][1] != want["strings"][1]:
        raise AssertionError(f"{name} bf16: the tier's stream is not the "
                             "per-slice stream with the fused flag")
    for what, d in (("fused", dec), ("per-slice", wdec), ("host", hdec)):
        e = henc if what == "host" else enc
        if not all(torch.equal(a, b) for a, b in zip(e["symbols"], d["symbols"])):
            raise AssertionError(f"{name} bf16 {what}: decoded symbols differ")
    if not all(torch.equal(a, b) for a, b in zip(enc["symbols"], henc["symbols"])):
        raise AssertionError(f"{name} bf16: lane and host walks quantized "
                             "different symbols")
    for what, d in (("per-slice", wdec), ("host", hdec)):
        if not torch.equal(d["x_hat"], dec["x_hat"]):
            raise AssertionError(f"{name} bf16 {what} x_hat is not bit-equal "
                                 "to the fused decompress's")
    if not host._pack_drain:
        raise AssertionError(f"{name} bf16: the host coder's drain is not packed")

    def b1(d, half):
        return sum(v for k, v in d.items() if k.startswith("window_attention")
                   and k.endswith("_bf16") == half)

    # (step, B1 bf16, B1 f32, B2, B3, B4). A tier's first compress runs its
    # graph's work eagerly and replays it, and so does its self-check's
    # first fused decompress; the split tier's analysis runs eagerly once
    first_b1 = A if mode == "split" else 2 * A
    expect = (
        (first_step, first_b1, 2 * A, 2 * S * P, 2 * S * P, 2 * pins),
        (replay_step, A, 0, 0, S * P, 0),
        (FUSED, 0, A, S * P, 0, pins),
        (PER_SLICE, 0, A, S * P, 0, 0),
        ("host compress", A, 0, 0, 0, 0),
        ("host decompress", 0, A, 0, 0, 0),
    )
    for step, *want_counts in expect:
        d = steps[step]
        got = [b1(d, True), b1(d, False), d.get("lane_decode", 0),
               d.get("lane_encode", 0), d.get("layout_pin", 0)]
        if got != want_counts:
            raise AssertionError(f"{name} bf16 {step}: B1 bf16/B1 f32/B2/B3/B4 "
                                 f"launches {got}, want {want_counts}")
    x_hat = dec["x_hat"]
    if x_hat.shape != (BENCH_BATCH, HEIGHT, WIDTH, 3) or not torch.isfinite(x_hat).all():
        raise AssertionError(f"{name} bf16: x_hat {tuple(x_hat.shape)} or "
                             "values bad")
    print(f"{name} bf16 first calls: "
          + "; ".join(f"{k} {v:.3f} s" for k, v in secs.items()))
    for what, step in (("compress", replay_step),
                       ("decompress", FUSED)):
        b1_calls = {k: v for k, v in steps[step].items()
                    if k.startswith("window_attention")}
        print(f"{name} bf16: B1 launches a {what} by instance {b1_calls} "
              f"(bf16 {b1(b1_calls, True)}, f32 {b1(b1_calls, False)})")

    calls = {
        f"{mode}-tier compress": lambda: strict(tier.compress, x),
        "fused decompress":
            lambda: strict(tier.decompress, enc["strings"], enc["shape"]),
    }
    warm = warm_medians(calls, WARM_CALLS)
    shares = []
    for what, fn in calls.items():
        wall, busy, _ = profile_call(fn, what)
        shares.append(f"{what} {wall * 1e3:.1f} ms wall, device busy "
                      f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%)")
    pixels = BENCH_BATCH * HEIGHT * WIDTH

    def stream_bits(e):
        return 8 * (sum(map(len, e["strings"][0])) + sum(map(len, e["strings"][1])))

    print(f"{name} bf16 bench path ({BENCH_BATCH}x{HEIGHT}x{WIDTH}, {opts}; "
          f"{smi}): warm per call, median of {WARM_CALLS}: "
          + "; ".join(f"{k} {v * 1e3:.1f} ms ({v * 1e3 / BENCH_BATCH:.2f} ms "
                      "an image)" for k, v in warm.items())
          + f"; peak memory {peak / 2 ** 30:.2f} GiB; profiled: "
          + "; ".join(shares) + f"; {stream_bits(enc) / pixels:.4f} bpp")

    # the f32 codec at the same weights and options
    f32 = Codec(model, coder="lane", device=dev, **opts)
    f32_enc = strict(f32.compress, x)
    f32_hat = strict(f32.decompress, f32_enc["strings"], f32_enc["shape"])["x_hat"]
    xf = torch.from_numpy(x).to(dev).float() / 255.0
    p16, p32 = psnr(x_hat, xf).item(), psnr(f32_hat, xf).item()
    print(f"{name} bf16 against f32 (seed weights, not an operating point): "
          f"PSNR to the image bf16 {p16:.4f} dB, f32 {p32:.4f} dB (gap "
          f"{p16 - p32:+.4f} dB); bf16 x_hat against the f32 x_hat "
          f"{psnr(x_hat, f32_hat).item():.2f} dB; bpp bf16 "
          f"{stream_bits(enc) / pixels:.4f}, f32 {stream_bits(f32_enc) / pixels:.4f}")
    return launches


# the eval CLI phase: the reference's seconds an image (encode, decode) on
# its GPU (BASELINE.md), printed beside the CLI's
REFERENCE_S = {"cnn": (0.12, 0.12), "stf": (0.15, 0.15)}
# the JAX CLI's per-image metric keys, by kind of run
EVAL_KEYS = {"psnr", "ms-ssim", "bpp", "encoding_time", "decoding_time",
             "first_use_encoding_time", "first_use_decoding_time"}
ESTIMATION_KEYS = {"psnr", "bpp", "encoding_time", "decoding_time"}
# bench.py's options (`BENCH_CODEC`) as the CLI's flags
BENCH_FLAGS = {
    "cnn": ["--pipeline", "2", "--fused-encode", "1"],
    "stf": ["--fused-encode", "split", "--transform-chunks", "3"],
}
HALF_PSNR_TOL = 0.05  # dB, the --half run against the f32 host run


def kodak_pngs(root):
    """Kodak's layout as PNGs in root/kodak: the 24 images of
    smooth_batch(24, 512, 768, seed=999), 16 at 512x768 and 8 transposed
    to 768x512. Returns (the folder, {file name: (width, height)})."""
    import numpy as np
    from PIL import Image

    x = (smooth_batch(BENCH_BATCH, HEIGHT, WIDTH, BENCH_SEED) * 255).astype(
        np.uint8)
    images = os.path.join(root, "kodak")
    os.makedirs(images)
    sizes = {}
    for i, img in enumerate(x):
        if i >= 16:
            img = img.transpose(1, 0, 2)
        name = f"kodim{i + 1:02d}.png"
        Image.fromarray(np.ascontiguousarray(img)).save(
            os.path.join(images, name))
        sizes[name] = (img.shape[1], img.shape[0])
    return images, sizes


def phase_eval_cli(dev, smi, images, sizes):
    """The port's eval CLI (`stf_tpu_torch.cli.eval_model.main`) on
    Kodak's layout (`kodak_pngs`: `images`, the files' `sizes`). For
    each full-width model (`smoke_model`, saved with the port's
    `save_checkpoint`): (a) --backend host at batch 1 in f32 (the
    reference's contract, per-image streams), the lane coder at batch 1
    in f32, (b) --backend lane --batch-size 24 --half with bench.py's
    options, and (c) --entropy-estimation. Checks the JSON document's
    keys, bpp > 0, finite PSNR, MS-SSIM in (0, 1], 24 reconstructions at
    their sizes, the f32 lane run's PSNR and MS-SSIM equal to the host
    run's, the --half run's PSNR within HALF_PSNR_TOL of it, no tier
    demoted (RuntimeWarnings are errors), and B1 (f32 and bf16), B2, B3
    and B4 each launched by the runs (counts set to 0 before each run and
    read after it). Then `prime_cache.main` for one bucket. Prints each
    run's warm and first-use seconds an image beside the reference's.
    Returns the phase's kernel launches."""
    import collections
    import contextlib
    import io
    import math
    import tempfile
    import warnings

    from PIL import Image

    from stf_tpu_torch import _native
    from stf_tpu_torch.cli import eval_model, prime_cache
    from stf_tpu_torch.zoo import save_checkpoint

    counts = _native.launch_counts
    launches = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="eval_cli_") as tmp:
        def run(tag, model_name, ckpt, flags, estimation=False):
            recon = os.path.join(tmp, f"recon_{model_name}_{tag}")
            argv = ["-d", images, "-a", model_name, "-p", ckpt, "-r", recon,
                    *flags]
            out = io.StringIO()
            counts.clear()  # this run starts here
            t0 = time.perf_counter()
            with warnings.catch_warnings(), contextlib.redirect_stdout(out):
                warnings.simplefilter("error", RuntimeWarning)  # a demotion
                eval_model.main(argv)
            secs = time.perf_counter() - t0
            ran = dict(counts)  # this run ends here
            launches.update(ran)
            doc = json.loads(out.getvalue())
            if doc.keys() != {"name", "description", "results"} or \
                    doc["name"] != model_name:
                raise AssertionError(f"eval {model_name} {tag}: document "
                                     f"{sorted(doc)}")
            r = {k: v[0] for k, v in doc["results"].items()}
            want = ESTIMATION_KEYS if estimation else EVAL_KEYS | (
                {"lane_framing_bpp"} if "lane" in flags else set())
            if r.keys() != want:
                raise AssertionError(f"eval {model_name} {tag}: keys "
                                     f"{sorted(r)}, want {sorted(want)}")
            if not (r["bpp"] > 0 and math.isfinite(r["psnr"])) or (
                    not estimation and not 0 < r["ms-ssim"] <= 1):
                raise AssertionError(f"eval {model_name} {tag}: {r}")
            written = sorted(os.listdir(recon))
            if written != sorted(sizes):
                raise AssertionError(f"eval {model_name} {tag}: wrote "
                                     f"{len(written)} reconstructions")
            for name in written:
                with Image.open(os.path.join(recon, name)) as im:
                    if im.size != sizes[name]:
                        raise AssertionError(f"eval {model_name} {tag}: "
                                             f"{name} is {im.size}")
            b1 = {k: v for k, v in ran.items()
                  if k.startswith("window_attention")}
            first = (f", first use {r['first_use_encoding_time'] * 1e3:.1f} + "
                     f"{r['first_use_decoding_time'] * 1e3:.1f} ms"
                     if "first_use_encoding_time" in r else "")
            # the estimation path has no cold call: its mean holds each
            # shape's first forward, as the JAX CLI's holds its compiles
            mean = ("the mean of all 24, each shape's first call included"
                    if estimation else "warm")
            print(f"eval {model_name} {tag} ({' '.join(flags) or 'defaults'}; "
                  f"{smi}): {r['encoding_time'] * 1e3:.2f} + "
                  f"{r['decoding_time'] * 1e3:.2f} ms an image, {mean}{first}; "
                  f"bpp {r['bpp']:.4f}"
                  + (f" (lane framing {r['lane_framing_bpp']:.4f})"
                     if "lane_framing_bpp" in r else "")
                  + f", PSNR {r['psnr']:.4f} dB"
                  + (f", MS-SSIM {r['ms-ssim']:.6f}" if "ms-ssim" in r else "")
                  + f"; reference {REFERENCE_S[model_name][0] * 1e3:.0f} + "
                  f"{REFERENCE_S[model_name][1] * 1e3:.0f} ms; command "
                  f"{secs:.1f} s; B1 {b1}, B2 {ran.get('lane_decode', 0)}, "
                  f"B3 {ran.get('lane_encode', 0)}, B4 "
                  f"{ran.get('layout_pin', 0)}")
            return r, ran

        for model_name in ("cnn", "stf"):
            ckpt = os.path.join(tmp, f"{model_name}.pth.tar")
            save_checkpoint(ckpt, model_name, smoke_model(model_name))
            host, _ = run("host", model_name, ckpt, ["--backend", "host"])
            lane, lane_ran = run("lane f32", model_name, ckpt,
                                 ["--backend", "lane"])
            half, half_ran = run("lane bf16 batch 24", model_name, ckpt,
                                 ["--backend", "lane", "--batch-size", "24",
                                  "--half", *BENCH_FLAGS[model_name]])
            est, est_ran = run("entropy estimation", model_name, ckpt,
                               ["--entropy-estimation"], estimation=True)
            if (lane["psnr"], lane["ms-ssim"]) != (host["psnr"], host["ms-ssim"]):
                raise AssertionError(
                    f"eval {model_name}: lane PSNR / MS-SSIM {lane['psnr']} / "
                    f"{lane['ms-ssim']} is not the host run's {host['psnr']} / "
                    f"{host['ms-ssim']}")
            gap = half["psnr"] - host["psnr"]
            if abs(gap) > HALF_PSNR_TOL:
                raise AssertionError(f"eval {model_name}: --half PSNR {gap:+.4f} "
                                     "dB from the f32 run")
            print(f"eval {model_name}: --half PSNR {gap:+.4f} dB from f32; "
                  f"entropy estimation {est['bpp']:.4f} bpp against the host "
                  f"coder's {host['bpp']:.4f} (PSNR {est['psnr']:.4f} dB)")

            def b1(d, half):
                return sum(v for k, v in d.items()
                           if k.startswith("window_attention")
                           and k.endswith("_bf16") == half)

            for what, got in (("B1 f32", b1(est_ran, False)),
                              ("B1 bf16", b1(half_ran, True)),
                              ("B2", lane_ran.get("lane_decode", 0)),
                              ("B3", half_ran.get("lane_encode", 0)),
                              ("B4", half_ran.get("layout_pin", 0))):
                if not got:
                    raise AssertionError(f"eval {model_name}: {what} never "
                                         "launched by the CLI")

        counts.clear()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            prime_cache.main(["-a", "cnn", "-p", os.path.join(tmp, "cnn.pth.tar"),
                              "--shapes", "512x768", "--batch-sizes", "1",
                              "--backend", "lane"])
        launches.update(counts)
    return dict(launches)


def kernel_group(key):
    """A kernel's kind by its name: B1, convolution (cuDNN's implicit-GEMM,
    FFT (with its complex GEMMs and transforms), direct and Winograd
    kernels), other GEMM (cuBLAS / CUTLASS), the optimizer's fused
    updates, or the rest (elementwise, reductions, norms, copies)."""
    k = key.lower()
    if "window_attention" in k:
        return "B1"
    if any(t in k for t in ("implicit_gemm", "cudnn", "fft", "dgrad",
                            "wgrad", "conv", "winograd", "cf32",
                            "region_transform")):
        return "convolution"
    if "gemm" in k:
        return "gemm"
    if "multi_tensor_apply" in k:
        return "optimizer"
    return "other"


def same_state(a, b):
    """True when two nested dicts / lists of tensors and plain values are
    equal, tensors bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_state(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_state(x, y) for x, y in zip(a, b)))
    return a == b


def phase_train(dev, smi, name):
    """The trainer on the full-width registry model `name`: TRAIN_STEPS
    steps of make_train_step on smooth_batch(TRAIN_BATCH, TRAIN_SIZE,
    TRAIN_SIZE, seed=step). Each step's losses must be finite and launch
    B1 exactly as its forward does (its backward runs PyTorch ops); after
    the first step every parameter has a finite gradient that is not all
    zero; the aux loss falls. Prints the first and last losses, the warm
    median step time and the kernel launches; saves a checkpoint and
    restores it into a fresh trainer (equal model, optimizer, schedule
    and generator states); records one step's B1 calls and holds each,
    forward and gradients, against the plain version at its shapes and
    data; prints B1's backward's device time at those shapes and one
    warm step's device time by kernel; and codes
    two images with the trained model through `codec_round_trip`."""
    import tempfile

    import numpy as np
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.training import TrainState, make_train_step
    from stf_tpu_torch.training.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from stf_tpu_torch.utils import psnr
    from stf_tpu_torch.zoo import create_model

    counts = _native.launch_counts
    b1 = lambda: sum(v for k, v in counts.items()  # noqa: E731
                     if k.startswith("window_attention"))
    per_step = sum(B1_CALLS[name])  # the training forward runs them all
    lmbda = TRAIN_LMBDA[name]
    model = create_model(name, seed=SEED)
    state = TrainState(model, dev, seed=SEED)
    step = make_train_step(model, lmbda)
    batches = [torch.from_numpy(smooth_batch(TRAIN_BATCH, TRAIN_SIZE,
                                             TRAIN_SIZE, i)).to(dev)
               for i in range(TRAIN_STEPS)]
    # Step 1 records which layers saw only zeros: a weight whose input is
    # zero everywhere has a zero gradient by the chain rule (at seed
    # weights z can round to 0 everywhere, and z_hat feeds the hyper
    # synthesis's first convolutions); every other gradient must not be.
    zero_fed, hooks = {}, []
    for mname, mod in model.named_modules():
        if not list(mod.children()) and isinstance(
                getattr(mod, "weight", None), torch.nn.Parameter):
            def hook(mod, args, mname=mname):
                zero_fed[mname] = (zero_fed.get(mname, True)
                                   and not args[0].any().item())
            hooks.append(mod.register_forward_pre_hook(hook))
    history, secs = [], []
    counts.clear()  # the training path starts here
    for i, x in enumerate(batches):
        before = b1()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, x)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name} train step {i + 1}: {m}")
        if b1() - before != per_step:
            raise AssertionError(f"{name} train step {i + 1}: {b1() - before} "
                                 f"B1 launches, want {per_step}")
        if i == 0:
            for h in hooks:
                h.remove()
            exempt = {f"{k}.weight" for k, z in zero_fed.items() if z}
            bad = [n for n, p in model.named_parameters()
                   if p.grad is None or not torch.isfinite(p.grad).all()
                   or not (p.grad.any() or n in exempt)]
            if bad:
                raise AssertionError(f"{name} train step 1: {len(bad)} "
                                     f"parameters without a finite nonzero "
                                     f"gradient, e.g. {bad[:5]}")
        history.append(m)
    launches = dict(counts)  # the training path ends here
    aux = [m["aux_loss"] for m in history]
    if not aux[-1] < aux[0]:
        raise AssertionError(f"{name}: the aux loss did not fall: {aux}")
    fmt = lambda ms: "; ".join(  # noqa: E731
        f"{m['loss']:.4f} (bpp {m['bpp_loss']:.4f}, mse {m['distortion']:.6f},"
        f" aux {m['aux_loss']:.2f})" for m in ms)
    print(f"{name} train ({TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}, lambda "
          f"{lmbda}, {TRAIN_STEPS} steps, launches {launches}): every step "
          f"finite with {per_step} B1 launches; step 1 gave all "
          f"{len(list(model.parameters()))} parameters a finite gradient, "
          f"nonzero but for the weights of layers fed only zeros "
          f"({sorted(exempt) or 'none'}); losses 1-5: {fmt(history[:5])}; losses "
          f"{TRAIN_STEPS - 4}-{TRAIN_STEPS}: {fmt(history[-5:])}")
    warm = secs[TRAIN_WARM:]
    print(f"{name} train step ({smi}): first {secs[0] * 1e3:.1f} ms; steps "
          f"{TRAIN_WARM + 1}-{TRAIN_STEPS} median {np.median(warm) * 1e3:.3f} ms "
          f"(min {min(warm) * 1e3:.3f}, max {max(warm) * 1e3:.3f}); peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")

    meta = {"model": name, "lmbda": lmbda, "metric": "mse"}
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, state, 0, history[-1]["loss"], meta, True,
                               history[-1]["loss"])
        fresh = TrainState(create_model(name, seed=SEED + 1), dev,
                           seed=SEED + 1)
        restore_checkpoint(path, fresh)
    for what in ("state_dict", "optimizer", "aux_optimizer", "lr_scheduler",
                 "generator", "step"):
        if not same_state(state.state_dict()[what], fresh.state_dict()[what]):
            raise AssertionError(f"{name}: restored {what} differs")
    print(f"{name} checkpoint after step {state.step}: model, both optimizers, "
          "schedule, generator and step restored equal")

    # B1 at the step's own shapes and data, and its backward's device time
    x = batches[-1]
    bwd_ms, n_calls = b1_step_check(f"{name} train step", step, state, x)
    print(f"{name} train step: B1's backward (PyTorch ops) {bwd_ms:.3f} ms "
          f"of device time in {n_calls} calls (graph replays at the step's "
          f"shapes; {smi})")
    device_time_by_kind(f"{name} warm train step", lambda: step(state, x), smi)

    img = (smooth_batch(2, TRAIN_SIZE, TRAIN_SIZE, SEED + 7) * 255).round()
    img = img.astype(np.uint8)
    an, hy, sy = B1_CALLS[name]
    rt = codec_round_trip(f"{name} trained", model, dev, img,
                          (an + hy, hy + sy))
    pixels = 2 * TRAIN_SIZE * TRAIN_SIZE
    nbytes = sum(map(len, rt.enc["strings"][0])) + sum(
        map(len, rt.enc["strings"][1]))
    xf = torch.from_numpy(img).to(dev).float() / 255.0
    print(f"{name} trained {state.step} steps through the codec "
          f"(2x{TRAIN_SIZE}x{TRAIN_SIZE}): lane {nbytes * 8 / pixels:.4f} bpp, "
          f"PSNR {psnr(rt.hdec['x_hat'], xf).item():.3f} dB")
    return model


def b1_step_check(tag, step, state, x):
    """Record one step's B1 backward calls (the saved qkv, bias, labels and
    the output gradient), then hold B1 at each against the plain version:
    the forward within ATTN_TOL (over max(1, largest output)) and the
    Function's d qkv, d bias within ATTN_GRAD_TOL of autograd through the
    plain version. Returns the backward's device ms at those calls (graph
    replays) and the number of calls."""
    from stf_tpu_torch.layers import attention_core as ac

    calls, backward = [], ac.window_attention_backward
    ac.window_attention_backward = lambda *a: calls.append(a) or backward(*a)
    try:
        step(state, x)
    finally:
        ac.window_attention_backward = backward
    worst = {}
    for qkv, bias, labels, ws, scale, gout in calls:
        out = ac._launch(qkv, bias, labels, ws, scale)
        plain = ac.window_attention_plain(qkv, bias, labels, ws, scale)
        errs = [(out - plain).abs().max().item()
                / max(1.0, plain.abs().max().item())]
        errs += attention_grad_errors(qkv, bias, labels, ws, scale, gout)
        if not (errs[0] <= ATTN_TOL and max(errs[1:]) <= ATTN_GRAD_TOL):
            raise AssertionError(
                f"{tag}: B1 at qkv {tuple(qkv.shape)} (shift labels: "
                f"{labels is not None}): forward, d qkv, d bias errors {errs}")
        key = tuple(qkv.shape)
        worst[key] = [max(a, b) for a, b in zip(worst.get(key, errs), errs)]
    print(f"{tag}: B1 at the step's {len(calls)} calls under autograd against "
          f"the plain version (forward tolerance {ATTN_TOL:g}; d qkv, d bias "
          f"{ATTN_GRAD_TOL:g}), worst by qkv shape: " + "; ".join(
              f"{k} {e[0]:.3g}, {e[1]:.3g}, {e[2]:.3g}"
              for k, e in sorted(worst.items(), key=lambda kv: -kv[0][1])))
    bwd_ms = sum(graph_ms(lambda a=a: backward(*a), 3) for a in calls)
    return bwd_ms, len(calls)


def device_time_by_kind(tag, fn, smi):
    """One warm call of `fn` in a profiler window of its own (after an
    untimed window that pays the tracer's start-up): prints its wall and
    busy time, its 14 costliest kernels, its device time by kernel kind
    (`kernel_group`) and the device spans of its record_function ranges;
    returns the busy ms."""
    profile_call(fn, "tracer start-up")
    wall, busy, events = profile_call(fn, tag)
    kernels = sorted((e for e in events if not is_range(e)), key=_device_us,
                     reverse=True)
    print(f"{tag} profiled ({smi}): {wall * 1e3:.3f} ms wall, device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%); by kernel: "
          + "; ".join(f"{e.key[:70]} {_device_us(e) / 1e3:.3f} ms in {e.count}"
                      for e in kernels[:14]))
    groups = {}
    for e in kernels:
        kind = kernel_group(e.key)
        groups[kind] = groups.get(kind, 0.0) + _device_us(e)
    spans = {e.key: (_device_us(e), e.count) for e in events if is_range(e)}
    print(f"{tag} device time by kind: " + "; ".join(
        f"{k} {v / 1e3:.3f} ms ({100 * v / 1e6 / busy:.1f}%)"
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
        + "; ranges (device span, overlapping the kernels above): "
        + "; ".join(f"{k} {us / 1e3:.3f} ms in {n}"
                    for k, (us, n) in sorted(spans.items())))
    return busy * 1e3


def training_folder(root, images, n_test=8):
    """An ImageFolder root over the Kodak PNGs: train/ links every image,
    test/ the first n_test."""
    data = os.path.join(root, "kodak_folder")
    for split in ("train", "test"):
        os.makedirs(os.path.join(data, split))
    for i, name in enumerate(sorted(os.listdir(images))):
        os.symlink(os.path.join(images, name),
                   os.path.join(data, "train", name))
        if i < n_test:
            os.symlink(os.path.join(images, name),
                       os.path.join(data, "test", name))
    return data


def run_cli(main, argv):
    """(main(argv)'s return, its standard output)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return ret, out.getvalue()


def phase_dytrain(dev, smi, teacher_model, data):
    """DYSTF distillation (`stf_tpu_torch.training.dytrain`) at full width.
    The teacher: `teacher_model` (phase_train's STF) saved by the zoo and
    read back with is_teacher, the --teacher-checkpoint route. The student:
    the full-width DYSTF of `smoke_model`. DYTRAIN_STEPS steps of
    make_dytrain_step (clf_weight 1: at the CLI's 0 the slice transforms
    get no RD gradient) on smooth_batch(TRAIN_BATCH, TRAIN_SIZE,
    TRAIN_SIZE, seed=step): every loss part finite; each step launches B1
    DYTRAIN_B1 times; after step 1 every student gradient finite, the
    predictors' nonzero; the teacher bit-unchanged. Prints each keep mask's
    share against its target, the warm median step, one step's device
    time by kind and B1's backward in it; holds B1 under autograd at one
    step's calls (the routed blocks' merged tokens) against the plain
    version; sends the distilled student through the codec
    (`codec_round_trip`); and runs `dytrain.main` for one epoch on the
    PNG folder `data` with --teacher-checkpoint. Returns the training
    path's launches and the round trip's."""
    import numpy as np
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.training import TrainState, dytrain, make_dytrain_step
    from stf_tpu_torch.training.checkpoint import load_checkpoint as load_ckpt
    from stf_tpu_torch.zoo import load_checkpoint, save_checkpoint

    counts = _native.launch_counts
    b1 = lambda: sum(v for k, v in counts.items()  # noqa: E731
                     if k.startswith("window_attention"))
    with tempfile.TemporaryDirectory(prefix="dytrain_") as tmp:
        tpath = os.path.join(tmp, "stf_teacher.pth.tar")
        save_checkpoint(tpath, "stf", teacher_model)
        teacher = load_checkpoint(tpath, "stf", device=dev, is_teacher=True)
        frozen = {k: v.clone() for k, v in teacher.state_dict().items()}
        if not (teacher.is_teacher and same_state(
                frozen, teacher_model.state_dict())):
            raise AssertionError("dytrain: the teacher did not load as saved")
        student = smoke_model("dystf")
        state = TrainState(student, dev, seed=SEED)
        step = make_dytrain_step(student, teacher, DYTRAIN_LMBDA,
                                 DYTRAIN_KEEP, clf_weight=1.0)
        batches = [torch.from_numpy(smooth_batch(TRAIN_BATCH, TRAIN_SIZE,
                                                 TRAIN_SIZE, i)).to(dev)
                   for i in range(DYTRAIN_STEPS)]
        history, secs = [], []
        counts.clear()  # the dytrain path starts here
        for i, x in enumerate(batches):
            before = b1()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts = step(state, x)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            m = {k: float(v) for k, v in parts.items()}
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"dytrain step {i + 1}: {m}")
            if b1() - before != DYTRAIN_B1:
                raise AssertionError(f"dytrain step {i + 1}: {b1() - before} "
                                     f"B1 launches, want {DYTRAIN_B1}")
            if i == 0:
                bad = [n for n, p in student.named_parameters()
                       if p.grad is None or not torch.isfinite(p.grad).all()
                       or (".score_predictor." in n and not p.grad.any())]
                if bad:
                    raise AssertionError(f"dytrain step 1: {len(bad)} student "
                                         f"gradients missing, not finite or "
                                         f"zero, e.g. {bad[:5]}")
            history.append(m)
        launches = dict(counts)  # the dytrain path ends here
        if not same_state(frozen, teacher.state_dict()):
            raise AssertionError("dytrain: the teacher's weights moved")
        with torch.no_grad():
            out = student(batches[-1], training=True, sampler=state.sampler)
        shares = [d.mean().item() for d in out["decisions"]]
        fmt = lambda m: ", ".join(f"{k} {v:.5g}" for k, v in m.items())  # noqa: E731
        warm = secs[TRAIN_WARM:]
        print(f"dytrain (dystf student, stf teacher from "
              f"--teacher-checkpoint's route, {TRAIN_BATCH}x{TRAIN_SIZE}x"
              f"{TRAIN_SIZE}, lambda {DYTRAIN_LMBDA}, clf_weight 1, "
              f"{DYTRAIN_STEPS} steps): every part finite, {DYTRAIN_B1} B1 "
              f"launches a step (student 24 + teacher 24), every student "
              f"gradient finite, the predictors' nonzero, the teacher "
              f"bit-unchanged; step 1: {fmt(history[0])}; step "
              f"{DYTRAIN_STEPS}: {fmt(history[-1])}; keep shares "
              + ", ".join(f"{s:.4f} (target {t})"
                          for s, t in zip(shares, DYTRAIN_KEEP)))
        print(f"dytrain step ({smi}): first {secs[0] * 1e3:.1f} ms; steps "
              f"{TRAIN_WARM + 1}-{DYTRAIN_STEPS} median "
              f"{np.median(warm) * 1e3:.3f} ms (min {min(warm) * 1e3:.3f}, "
              f"max {max(warm) * 1e3:.3f}); peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
        bwd_ms, n_calls = b1_step_check("dytrain step", step, state,
                                        batches[-1])
        busy = device_time_by_kind("dytrain step", lambda: step(
            state, batches[-1]), smi)
        print(f"dytrain step: B1's backward (PyTorch ops) {bwd_ms:.3f} ms of "
              f"device time in {n_calls} calls (graph replays at the step's "
              f"shapes), {100 * bwd_ms / busy:.1f}% of the step's device "
              f"busy time ({smi})")

        img = (smooth_batch(BATCH, HEIGHT, WIDTH, SEED) * 255).round()
        student.eval()
        an, hy, sy = B1_CALLS["dystf"]
        rt = codec_round_trip("dystf distilled", student, dev,
                              img.astype(np.uint8), (an + hy, hy + sy))

        save_dir = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        cli_state, log = run_cli(dytrain.main, [
            "-d", data, "-e", "1", "--batch-size", str(TRAIN_BATCH),
            "--patch-size", str(TRAIN_SIZE), str(TRAIN_SIZE),
            "--lambda", str(DYTRAIN_LMBDA), "--clf-weight", "1",
            "--teacher-checkpoint", tpath, "--save-dir", save_dir,
            "--num-workers", "4", "--log-every", "1"])
        cli_s = time.perf_counter() - t0
        n_train = len(os.listdir(os.path.join(data, "train")))
        ckpt = load_ckpt(os.path.join(save_dir, "checkpoint.pth.tar"))
        test = [line for line in log.splitlines()
                if line.startswith("dytrain test epoch 0: loss")]
        if (cli_state.step != n_train // TRAIN_BATCH or len(test) != 1
                or not np.isfinite(ckpt["loss"]) or ckpt["epoch"] != 0):
            raise AssertionError(f"dytrain.main: {cli_state.step} steps, "
                                 f"log {log[-500:]!r}")
        print(f"dytrain.main, one epoch on {data} ({n_train} images, batch "
              f"{TRAIN_BATCH}, --teacher-checkpoint): {cli_state.step} steps "
              f"in {cli_s:.1f} s; {test[0]}")
    return launches, rt.launches


def phase_train_gd(dev, smi, images):
    """Gate-decorator pruning (`stf_tpu_torch.training.train_gd`) of the
    full-width CC_GD (N 192, M 320, 10 slices; gates and masks at their
    init of ones): GD_STEPS tock steps (RD + GD_SPARSE * L1 + aux) on
    smooth_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE), losses finite; one
    tick of GD_ROUNDS rounds over GD_SUBSET of those batches pruning
    GD_TICK_NUM channels a round: param_scale falls, only gates and masks
    move. Then z's gate unmasked (`h_a/gate_2` protected: pruning z is
    approximate by design), `prune_export` to a temporary folder and
    `zoo.load_checkpoint` of it on the card: its eval forward within 1e-5
    of the masked gated model's, on 2x512x768; parameter counts before
    and after; the pruned model through the lane and host coders
    (`codec_round_trip`), B2, B3 and B4 launched; warm compress and
    decompress medians beside the gated model's; and `eval_model.main -a
    cc_gd` on the export over the Kodak PNGs `images`. Returns the round
    trip's launches."""
    import numpy as np
    import torch

    from stf_tpu_torch.cli import eval_model
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.training import (
        TrainState,
        iter_gates,
        make_gd_train_step,
        param_scale,
        prune_export,
        train_gd,
    )
    from stf_tpu_torch.zoo import create_model, load_checkpoint

    model = create_model("cc_gd", seed=SEED)
    state = TrainState(model, dev, seed=SEED)
    step = make_gd_train_step(model, GD_LMBDA, GD_SPARSE)
    batches = [torch.from_numpy(smooth_batch(TRAIN_BATCH, TRAIN_SIZE,
                                             TRAIN_SIZE, 100 + i)).to(dev)
               for i in range(GD_STEPS)]
    secs = []
    for i, x in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in step(state, x).items()}
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train_gd step {i + 1}: {m}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    scale = param_scale(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_gd.tick(model, lambda: iter(batches[:GD_SUBSET]), GD_LMBDA,
                  state.sampler, GD_ROUNDS, GD_TICK_NUM, 1e-4)
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    pruned_scale = param_scale(model)
    total = sum(g.mask.numel() for _, g in iter_gates(model))
    if not pruned_scale <= scale - GD_ROUNDS * GD_TICK_NUM / total:
        raise AssertionError(f"train_gd tick: param_scale {scale} -> "
                             f"{pruned_scale}")
    moved = [k for k, v in model.state_dict().items()
             if not k.endswith((".gate", ".mask"))
             and not torch.equal(v, before[k])]
    if moved:
        raise AssertionError(f"train_gd tick moved {moved[:5]}")
    print(f"train_gd (cc_gd, {TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}, lambda "
          f"{GD_LMBDA}, sparse lambda {GD_SPARSE}): {GD_STEPS} tock steps, "
          f"last {m}; step median {np.median(secs[1:]) * 1e3:.3f} ms ({smi}); "
          f"one tick ({GD_ROUNDS} rounds over {GD_SUBSET} batches, "
          f"{GD_TICK_NUM} channels a round) {tick_s:.2f} s; param_scale "
          f"{scale:.4f} -> {pruned_scale:.4f}; only gates and masks moved")

    with torch.no_grad():
        dict(iter_gates(model))["h_a/gate_2"].mask.fill_(1.0)
    model.eval()
    img = (smooth_batch(BATCH, HEIGHT, WIDTH, SEED) * 255).round().astype(
        np.uint8)
    xf = torch.from_numpy(img).to(dev).float() / 255.0
    with tempfile.TemporaryDirectory(prefix="train_gd_") as tmp:
        _, deps = prune_export(model, tmp)
        path = os.path.join(tmp, train_gd.PRUNED_MODEL)
        pruned = load_checkpoint(path, "cc_gd", device=dev)
        n_gated = sum(p.numel() for p in model.parameters())
        n_pruned = sum(p.numel() for p in pruned.parameters())
        with torch.no_grad():
            got, want = pruned(xf), model(xf)
        errs = {k: (got[k] - want[k]).abs().max().item() for k in ("x_hat",)}
        errs.update({k: (got["likelihoods"][k] - want["likelihoods"][k])
                     .abs().max().item() for k in ("y", "z")})
        if not max(errs.values()) <= 1e-5:
            raise AssertionError(f"train_gd: the pruned model's eval forward "
                                 f"against the gated model's: {errs}")
        rt = codec_round_trip("cc_gd pruned", pruned, dev, img, (0, 0))
        lane, enc = rt.lane, rt.enc
        for k in ("lane_decode", "lane_encode", "layout_pin"):
            if not rt.launches.get(k):
                raise AssertionError(f"train_gd: {k} never launched")
        gated = Codec(model, coder="lane", device=dev)
        genc = gated.compress(img)
        gated.decompress(genc["strings"], genc["shape"])  # capture
        warm = warm_medians({
            "pruned compress": lambda: lane.compress(img),
            "pruned fused decompress": lambda: lane.decompress(
                enc["strings"], enc["shape"]),
            "gated compress": lambda: gated.compress(img),
            "gated fused decompress": lambda: gated.decompress(
                genc["strings"], genc["shape"])})
        print(f"train_gd prune_export: {sum(deps.values())} of {total} gated "
              f"channels kept at {len(deps)} gates; parameters {n_gated} -> "
              f"{n_pruned} ({100 * n_pruned / n_gated:.1f}%); reloaded on the "
              f"card, its eval forward against the gated model's (z's gate "
              f"unmasked), max abs {errs}; warm medians of 5 "
              f"({BATCH}x{HEIGHT}x{WIDTH}, lane coder, {smi}): "
              + "; ".join(f"{k} {v * 1e3:.3f} ms" for k, v in warm.items()))
        _, out = run_cli(eval_model.main, ["-d", images, "-a", "cc_gd", "-p",
                                           path, "--backend", "lane"])
        doc = json.loads(out)
        r = {k: v[0] for k, v in doc["results"].items()}
        if doc["name"] != "cc_gd" or not (r["bpp"] > 0 and np.isfinite(
                r["psnr"])):
            raise AssertionError(f"eval_model -a cc_gd on the export: {doc}")
        print(f"eval_model -a cc_gd -p {train_gd.PRUNED_MODEL} --backend lane "
              f"({len(os.listdir(images))} Kodak-layout PNGs, {smi}): "
              f"{r['encoding_time'] * 1e3:.2f} + {r['decoding_time'] * 1e3:.2f}"
              f" ms an image warm, bpp {r['bpp']:.4f}, PSNR {r['psnr']:.4f} dB")
    return rt.launches


# the parallel phase: the trainer CLI's epochs of TRAIN_BATCH crops on the
# Kodak PNGs, each linked twice (48 train images: 6 steps an epoch, the
# first cold), and PAR_STEPS steps of two ranks; a child that overruns
# PAR_TIMEOUT seconds fails the smoke
PAR_STEPS, PAR_TIMEOUT = 6, 400
# tests/test_torch_parallel.py's tolerances: losses rel PAR_RTOL, the
# parameters after the first update within PAR_ATOL, and Adam's first
# moment after it (0.1 x the averaged, clipped gradient) within
# PAR_MOMENT_RTOL of each tensor's largest entry; the losses of the first
# PAR_CHECKED steps are held to one process's (later ones drift: Adam's
# sign-like first steps flip on gradients near zero)
PAR_RTOL, PAR_ATOL, PAR_MOMENT_RTOL, PAR_CHECKED = 1e-5, 5e-4, 1e-3, 2


def run_child(argv, timeout=PAR_TIMEOUT):
    """Run `argv` in a session of its own; return its standard output's
    JSON lines. On a non-zero exit or an overrun the whole session is
    killed (torch.distributed.run's workers too) and the smoke fails."""
    import signal

    t0 = time.perf_counter()
    p = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        raise AssertionError(f"{argv[:6]} overran {timeout} s:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    if p.returncode:
        raise AssertionError(f"{argv[:6]} exited {p.returncode}:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return lines, time.perf_counter() - t0


def torchrun(nproc, *args):
    """argv: this script's child mode `args` under torch.distributed.run
    with `nproc` processes on this host."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", os.path.abspath(__file__),
            "--child", *args]


def child_cli(*argv):
    """Child mode: `recorded_cli(argv)`; rank 0 prints its record as one
    JSON line."""
    from stf_tpu_torch import parallel

    rec = recorded_cli(argv)
    if parallel.is_main_process():
        print(json.dumps(rec))


def recorded_cli(argv):
    """`stf_tpu_torch.training.train.main(argv)` with each step's loss,
    wall seconds and B1 launches recorded, and the sharded checkpointer's
    save, close, restore and sidecar read-back timed: the record, with
    the final step and the world size. The patched factories and methods
    are put back."""
    import torch

    from stf_tpu_torch import _native, parallel
    from stf_tpu_torch.training import checkpoint, state as train_state
    from stf_tpu_torch.training import train

    rec = {"losses": [], "secs": [], "b1": [], "ckpt_s": {}}
    b1 = lambda: b1_launches(_native.launch_counts)  # noqa: E731
    # a CPU run (--device cpu) rehearses this child without a card
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else lambda: None)

    def recording(step):
        """`step` recorded; the parallel step records its whole (its
        metrics averaged over the ranks) in place of the inner step's."""
        def run(state, batch):
            before = b1()
            sync()
            t0 = time.perf_counter()
            m = step(state, batch)
            rec["losses"].append(float(m["loss"]))
            sync()
            rec["secs"].append(time.perf_counter() - t0)
            rec["b1"].append(b1() - before)
            return m
        run.inner = step
        return run

    def timing(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec["ckpt_s"][name] = rec["ckpt_s"].get(name, 0.0) + (
                time.perf_counter() - t0)
            return out
        return run

    make_step, make_parallel = (train_state.make_train_step,
                                parallel.make_parallel_train_step)
    ck = checkpoint.ShardedCheckpointer
    saved = [(train_state, "make_train_step", make_step),
             (parallel, "make_parallel_train_step", make_parallel)] + [
        (ck, name, ck.__dict__[name]) for name in ("save", "close",
                                                   "restore",
                                                   "_write_sidecar")]
    train_state.make_train_step = lambda *a, **k: recording(
        make_step(*a, **k))
    parallel.make_parallel_train_step = lambda step: recording(
        make_parallel(step.inner))
    for name in ("save", "close", "restore", "_write_sidecar"):
        setattr(ck, name, timing(name, ck.__dict__[name]))
    try:
        state = train.main(list(argv))
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return dict(rec, step=state.step, world=parallel.process_count())


def first_moments(state):
    """{parameter name: Adam's first moment} of both optimizers of a
    TrainState, on this rank (a sharded moment's local shard)."""
    out = {}
    for name, p in state.model.named_parameters():
        opt = (state.optimizer if p in state.optimizer.state
               else state.aux_optimizer)
        out[name] = opt.state[p]["exp_avg"]
    return out


def rank_record(named):
    """{name: CPU tensor} of a rank's tensors (a sharded one's local
    shard) and the names of the sharded ones, for `join_ranks`."""
    return {"tensors": {k: local_shards(v).detach().to("cpu", copy=True)
                        for k, v in named.items()},
            "sharded": sorted(k for k, v in named.items()
                              if hasattr(v, "to_local"))}


def join_ranks(records):
    """{name: whole tensor} from every rank's `rank_record`: sharded
    entries (fully_shard's dim 0) joined in rank order, whole ones rank
    0's."""
    import torch

    first = records[0]
    return {k: (torch.cat([r["tensors"][k] for r in records])
                if k in first["sharded"] else v)
            for k, v in first["tensors"].items()}


def child_ranks(out_dir, lmbda):
    """Child mode, one of two ranks sharing cuda:0 over gloo: for DDP and
    for --tp 2 (fully_shard), PAR_STEPS steps of the full-width STF on
    this rank's rows of smooth_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE,
    seed=SEED), each timed. Rank 0 (each rank with --tp 2) writes
    out_dir/tp<T>/rank<R>.pt: its parameters and first moments after the
    first step (local shards with --tp 2, no collective), and with --tp 2
    its parameters after the last. The
    --tp 2 state is then saved sharded (its sidecar read-back timed
    apart from the save's landing) and restored into a fresh model, mesh
    and TrainState, bit-equal by local shard. Each rank prints one JSON
    line."""
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.parallel import (
        create_mesh,
        data_parallel_shardings,
        initialize_distributed,
        make_parallel_train_step,
        parallelize,
        process_index,
        shard_batch,
    )
    from stf_tpu_torch.training import TrainState, make_train_step
    from stf_tpu_torch.training.checkpoint import (
        ShardedCheckpointer,
        _train_state,
    )
    from stf_tpu_torch.zoo import create_model

    dev = initialize_distributed(device="cuda", backend="gloo")
    lmbda = float(lmbda)
    x = torch.from_numpy(smooth_batch(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE,
                                      SEED))
    rank = process_index()
    out = {"rank": rank, "device": str(dev)}

    def build(tp, seed):
        mesh = create_mesh(batch_size=len(x), model=tp, device_type="cuda")
        model = create_model("stf", seed=seed).to(dev)
        forward = parallelize(model, mesh)
        state = TrainState(model, dev, seed=SEED,
                           shard=data_parallel_shardings(mesh))
        return mesh, forward, state

    for tp in (1, 2):
        mesh, forward, state = build(tp, SEED)
        step = make_parallel_train_step(make_train_step(forward, lmbda))
        batch = shard_batch(x, mesh).to(dev)
        r = out[f"tp{tp}"] = {"losses": [], "secs": [], "b1": []}
        saved = {}
        for i in range(PAR_STEPS):
            before = b1_launches(_native.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r["losses"].append(float(step(state, batch)["loss"]))
            torch.cuda.synchronize()
            r["secs"].append(time.perf_counter() - t0)
            r["b1"].append(b1_launches(_native.launch_counts) - before)
            if i == 0:
                saved["params1"] = rank_record(dict(
                    state.model.named_parameters()))
                saved["moments1"] = rank_record(first_moments(state))
        root = os.path.join(out_dir, f"tp{tp}")
        os.makedirs(root, exist_ok=True)
        if tp == 2:
            saved["params"] = rank_record(dict(
                state.model.named_parameters()))
        if tp == 2 or rank == 0:  # DDP's ranks hold the same
            torch.save(saved, os.path.join(root, f"rank{rank}.pt"))
        del saved
        if tp == 1:
            # the CLI's sharded save of a DDP run is (a)'s
            continue
        ckpt = ShardedCheckpointer(root)
        sidecar_s = []

        def timed_sidecar(*a, _write=ckpt._write_sidecar):
            t0 = time.perf_counter()
            _write(*a)
            sidecar_s.append(time.perf_counter() - t0)

        ckpt._write_sidecar = timed_sidecar
        t0 = time.perf_counter()
        ckpt.save(state, 0, r["losses"][-1], {"model": "stf", "lmbda": lmbda,
                                              "metric": "mse"}, True,
                  r["losses"][-1])
        r["save_s"] = time.perf_counter() - t0
        ckpt.close()
        r["landed_s"] = time.perf_counter() - t0 - sum(sidecar_s)
        r["sidecar_s"] = sum(sidecar_s)
        _, _, fresh = build(tp, SEED + 1)
        t0 = time.perf_counter()
        meta = ShardedCheckpointer(root, read_only=True).restore(fresh)
        r["restore_s"] = time.perf_counter() - t0
        r["restored_equal"] = (
            same_state(local_shards(_train_state(state)),
                       local_shards(_train_state(fresh)))
            and meta["epoch"] == 0 and fresh.step == PAR_STEPS)
    print(json.dumps(out))


def local_shards(tree):
    """A nested state dict with each sharded tensor replaced by this
    rank's shard (for `same_state`)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to_local() if hasattr(tree, "to_local") else tree
    if isinstance(tree, dict):
        return {k: local_shards(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [local_shards(v) for v in tree]
    return tree


def parallel_folder(root, data):
    """An ImageFolder root with every train image of `data` linked twice
    and its test images once."""
    par = os.path.join(root, "parallel_folder")
    for split in ("train", "test"):
        os.makedirs(os.path.join(par, split))
        for name in sorted(os.listdir(os.path.join(data, split))):
            src = os.path.realpath(os.path.join(data, split, name))
            copies = ("a_", "b_") if split == "train" else ("",)
            for prefix in copies:
                os.symlink(src, os.path.join(par, split, prefix + name))
    return par


def spread(secs):
    """'median ms (min-max, n warm steps)' of steps after the first."""
    import numpy as np

    warm = np.asarray(secs[1:]) * 1e3
    return (f"{np.median(warm):.3f} ms ({warm.min():.3f}-{warm.max():.3f}, "
            f"{len(warm)} warm steps)")


def phase_parallel(dev, smi, data):
    """Multi-process training (`stf_tpu_torch.parallel`) at full width,
    in child processes that `python -m torch.distributed.run` starts:
    (a) the trainer CLI (`-m stf`, TRAIN_BATCH x TRAIN_SIZE crops of
    `parallel_folder`) at world size 1 over NCCL with --ckpt-format
    sharded for one epoch, then resumed from its save directory for one
    more: the first step's loss against the single-process CLI's at the
    same seed, the step count after the resume, B1 24 times a step, the
    warm steps' median and spread, the save, landing, sidecar read-back
    and restore seconds; (b) two ranks sharing this card over gloo, DDP
    and --tp 2 (`child_ranks`): PAR_STEPS timed steps, the first
    PAR_CHECKED losses against this process's one-process steps on the
    same global batch (rel PAR_RTOL), and after the first update the
    parameters (PAR_ATOL) and Adam's first moments (PAR_MOMENT_RTOL);
    then the --tp 2 state saved sharded, restored bit-equal, its sidecar
    equal to the ranks' last parameters; (c) the params sidecar of (a)
    loaded by `zoo.load_checkpoint` and coded (`codec_round_trip`, B1-B4
    launches checked); (d) `python -m stf_tpu_torch.utils.flops -a stf`
    at TRAIN_SIZE on the card against this process's CPU count, and the
    card's count of each full-width model. Returns the round trip's
    launches."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from stf_tpu_torch.training import TrainState, make_train_step
    from stf_tpu_torch.training.state import is_aux_parameter
    from stf_tpu_torch.utils.flops import model_flops
    from stf_tpu_torch.zoo import create_model, load_checkpoint

    lmbda = TRAIN_LMBDA["stf"]
    per_step = sum(B1_CALLS["stf"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as work:
        # (a) the CLI: NCCL at world 1, sharded format, and a resume
        save = os.path.join(work, "save")
        folder = parallel_folder(work, data)
        epoch_steps = len(os.listdir(os.path.join(folder, "train"))) // (
            TRAIN_BATCH)
        cli = ["-m", "stf", "-d", folder,
               "--batch-size", str(TRAIN_BATCH),
               "--test-batch-size", str(TRAIN_BATCH), "--patch-size",
               str(TRAIN_SIZE), str(TRAIN_SIZE), "--lambda", str(lmbda),
               "--num-workers", "4", "--log-every", "1", "--seed",
               str(SEED), "--device", "cuda"]
        # the single-process reference runs here: the card and the
        # kernels are this process's already
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            ref = recorded_cli(cli + ["-e", "1", "--save-dir",
                                      os.path.join(work, "single")])
        ref_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(work, "single"))  # disk: ~2.4 GB
        (first,), first_s = run_child(torchrun(
            1, "cli", *cli, "-e", "1", "--save-dir", save,
            "--ckpt-format", "sharded"))
        (second,), second_s = run_child(torchrun(
            1, "cli", *cli, "-e", "2", "--save-dir", save, "--ckpt-format",
            "sharded", "--checkpoint", save))
        for tag, r in (("single", ref), ("ddp", first), ("resumed", second)):
            if (len(r["losses"]) != epoch_steps
                    or set(r["b1"]) != {per_step}):
                raise AssertionError(f"parallel {tag} CLI: {r}")
        if first["world"] != 1 or second["step"] != 2 * epoch_steps:
            raise AssertionError(f"parallel CLI: world {first['world']}, "
                                 f"step after the resume {second['step']}")
        diff = first["losses"][0] - ref["losses"][0]
        print(f"parallel (a) trainer CLI, stf {TRAIN_BATCH}x{TRAIN_SIZE}x"
              f"{TRAIN_SIZE}, torch.distributed.run NCCL world 1, "
              f"--ckpt-format sharded: first loss {first['losses'][0]!r} "
              f"against the single-process CLI's {ref['losses'][0]!r} "
              f"(difference {diff!r}); losses {first['losses']} then "
              f"{second['losses']} after the resume at step "
              f"{second['step'] - epoch_steps}, {second['step']} steps; "
              f"B1 {per_step} launches a step; the single-process CLI "
              f"{ref_s:.1f} s (in this process), the children "
              f"{first_s:.1f} / {second_s:.1f} s")
        if diff != 0.0:
            raise AssertionError("parallel (a): DDP at world 1 changed the "
                                 "first step's loss")
        ck = lambda r: {k: round(v, 3)  # noqa: E731
                        for k, v in sorted(r["ckpt_s"].items())}
        print(f"parallel (a) step ({smi}): single process "
              f"{spread(ref['secs'])}; DDP world 1 {spread(first['secs'])}; "
              f"after the resume {spread(second['secs'])}; sharded "
              f"checkpointer seconds (save = start of the async save and "
              f"the wait for the previous; close = the last landing and "
              f"its sidecar; _write_sidecar = rank 0's read-backs, inside "
              f"save and close): first run {ck(first)}, resumed run "
              f"{ck(second)}")

        # (b) two ranks on this card over gloo, DDP and --tp 2
        ranks, ranks_s = run_child(torchrun(2, "ranks", work, str(lmbda)))
        ranks.sort(key=lambda r: r["rank"])  # printed in either order
        model = create_model("stf", seed=SEED)
        state = TrainState(model, dev, seed=SEED)
        step = make_train_step(model, lmbda)
        x = torch.from_numpy(smooth_batch(TRAIN_BATCH, TRAIN_SIZE,
                                          TRAIN_SIZE, SEED)).to(dev)
        one = [float(step(state, x)["loss"])]
        want_params = {k: v.detach().to("cpu", copy=True)
                       for k, v in model.named_parameters()}
        want_moments = {k: v.to("cpu", copy=True)
                        for k, v in first_moments(state).items()}
        one += [float(step(state, x)["loss"])
                for _ in range(PAR_CHECKED - 1)]
        clipped = float(sum(torch.sum((m.double() / 0.1) ** 2)
                            for k, m in want_moments.items()
                            if not is_aux_parameter(k)) ** 0.5)
        for tp in (1, 2):
            recs = [torch.load(os.path.join(work, f"tp{tp}", f"rank{i}.pt"))
                    for i in range(tp)]
            params = join_ranks([r["params1"] for r in recs])
            moments = join_ranks([r["moments1"] for r in recs])
            p_gap = max((params[k] - want_params[k]).abs().max().item()
                        for k in want_params)
            m_gap = max(((moments[k] - want_moments[k]).abs().max()
                         / want_moments[k].abs().max().clamp_min(1e-30))
                        .item() for k in want_moments)
            bad = p_gap > PAR_ATOL or m_gap > PAR_MOMENT_RTOL
            for r in ranks:
                t = r[f"tp{tp}"]
                bad = bad or (
                    not np.allclose(t["losses"][:PAR_CHECKED], one,
                                    rtol=PAR_RTOL, atol=0)
                    or set(t["b1"]) != {per_step}
                    or not t.get("restored_equal", tp == 1))
            t = ranks[0][f"tp{tp}"]
            if tp == 2:
                last = join_ranks([r["params"] for r in recs])
                side = torch.load(os.path.join(work, "tp2",
                                               "params_best.pth.tar"))
                bad = bad or not all(torch.equal(side[k], last[k])
                                     for k in last)
            if bad:
                raise AssertionError(
                    f"parallel (b) tp {tp}: {ranks} against one process's "
                    f"losses {one}; parameters after the first update "
                    f"within {p_gap}, first moments {m_gap}")
            print(f"parallel (b) two ranks on {ranks[0]['device']} over "
                  f"gloo, {'DDP' if tp == 1 else '--tp 2 (fully_shard)'}: "
                  f"losses {t['losses']}, the first {PAR_CHECKED} against "
                  f"one process's {one}; after the first update the "
                  f"parameters within {p_gap:.3g} and the first moments "
                  f"within {m_gap:.3g} of each tensor's largest (one "
                  f"process's clipped gradient norm {clipped:.6f}); step "
                  f"(rank 0; {smi}) {spread(t['secs'])}, all "
                  f"{[round(v, 4) for v in t['secs']]} s"
                  + ("" if tp == 1 else
                     f"; sharded save {t['save_s']:.3f} s, landed "
                     f"{t['landed_s']:.3f} s without rank 0's sidecar "
                     f"read-backs {t['sidecar_s']:.3f} s, restore "
                     f"{t['restore_s']:.3f} s, bit-equal on both ranks, "
                     f"the sidecar equal to the ranks' last parameters"))
        print(f"parallel (b) child {ranks_s:.1f} s")

        # (c) the sidecar through the codec
        sidecar = load_checkpoint(os.path.join(save, "params_best.pth.tar"),
                                  device=dev)
        img = (smooth_batch(2, TRAIN_SIZE, TRAIN_SIZE, SEED + 7) * 255)
        an, hy, sy = B1_CALLS["stf"]
        rt = codec_round_trip("parallel (c) sharded run's sidecar", sidecar,
                              dev, img.round().astype(np.uint8),
                              (an + hy, hy + sy))

    # (d) the FLOP counter on the card against the CPU
    (flops,), flops_s = run_child(
        [sys.executable, os.path.abspath(__file__), "--child", "flops",
         "stf", str(TRAIN_SIZE)])
    cpu = model_flops(create_model("stf", seed=0), (1, TRAIN_SIZE,
                                                   TRAIN_SIZE, 3), "cpu")
    if flops["flops"] != cpu["flops"]:
        raise AssertionError(f"parallel (d): card {flops} against the "
                             f"CPU's {cpu}")
    print(f"parallel (d) stf at {TRAIN_SIZE}x{TRAIN_SIZE}: the card's count "
          f"{flops['flops']} FLOPs (B1 {flops['by_op']['window_attention']}) "
          f"equals the CPU's; child {flops_s:.1f} s")
    for name in CODEC_MODELS:
        st = model_flops(create_model(name, seed=0),
                         (1, TRAIN_SIZE, TRAIN_SIZE, 3), dev)
        print(f"flops {name} at {TRAIN_SIZE}x{TRAIN_SIZE} on the card: "
              f"{st['flops']} ({st['flops'] / 1e9:.3f} G), params "
              f"{st['params']}, by op {st['by_op']}")
    return rt.launches


def child_flops(name, size):
    """Child mode: `python -m stf_tpu_torch.utils.flops`'s main on the
    card; prints its stats as one JSON line."""
    from stf_tpu_torch.utils import flops

    stats = flops.main(["-a", name, "--height", size, "--width", size])
    print(json.dumps(stats))


CHILDREN = {"cli": child_cli, "ranks": child_ranks, "flops": child_flops}


def sm_clock_mhz():
    """The card's maximum SM clock, MHz, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return float(out.strip().splitlines()[0])


def ptxas_summary(log):
    """One line per kernel from nvcc's -Xptxas -v output: its mangled
    name, registers, spill bytes and static shared memory."""
    import re

    out, name, spills = [], None, "spills not reported"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spills = (f"stack frame {m.group(1)} B, spill stores "
                      f"{m.group(2)} B, loads {m.group(3)} B")
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append(f"{name}: {m.group(1)} registers, {spills}, static smem "
                       f"{smem.group(1) if smem else 0} B")
            name = None
    return out


def main():
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        # a child process of phase_parallel; a crash prints its stack
        import faulthandler

        faulthandler.enable()
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        CHILDREN[sys.argv[2]](*sys.argv[3:])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "stf_tpu_torch")):
        print("chip_smoke: stf_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sm_mhz = sm_clock_mhz()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | {smi} | max SM clock {sm_mhz:g} MHz | torch "
          f"{torch.__version__} | cuda {torch.version.cuda}")

    from stf_tpu_torch import _native

    t0 = time.perf_counter()
    _native.build_all(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(_native.CUDA_LIBS))} with nvcc sm_90a, rans with g++)")
    for lib in _native.CUDA_LIBS:
        for line in ptxas_summary(_native.build_logs[lib]):
            print(f"ptxas {lib}: {line}")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 plain versions
    torch.backends.cudnn.allow_tf32 = False

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    rows = (phase("attention", phase_attention, dev, sm_mhz)
            + phase("attention_bf16", phase_attention_bf16, dev, sm_mhz)
            + phase("lane_decode", phase_lane_decode, dev, sm_mhz)
            + phase("lane_encode", phase_lane_encode, dev, sm_mhz)
            + phase("layout_pin", phase_layout_pin, dev)
            + phase("conv", phase_conv, dev))
    launches = {name: phase(f"codec {name}", phase_codec, dev, smi, name)
                for name in CODEC_MODELS}
    phase("stf_seed_fallback", phase_stf_seed_fallback, dev)
    launches["tbc_bf16"] = phase("tbc_bf16", phase_tbc_bf16, dev, smi)
    for model_name in ("cnn", "stf"):
        launches[f"{model_name}_bf16"] = phase(
            f"codec_bf16 {model_name}", phase_codec_bf16, dev, smi, model_name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        images, sizes = kodak_pngs(work)
        eval_launches = phase("eval_cli", phase_eval_cli, dev, smi, images,
                              sizes)
        print(f"eval CLI phase launches: {eval_launches}")
        trained = {name: phase(f"train {name}", phase_train, dev, smi, name)
                   for name in ("cnn", "stf")}
        data = training_folder(work, images)
        dy_train, dy_codec = phase(
            "dytrain", phase_dytrain, dev, smi, trained["stf"], data)
        gd_codec = phase("train_gd", phase_train_gd, dev, smi, images)
        par_codec = phase("parallel", phase_parallel, dev, smi, data)
    print(f"dytrain path launches: training {dy_train}; the distilled "
          f"DYSTF's round trip {dy_codec}")
    print(f"train_gd path launches: the pruned CC_GD's round trip {gd_codec}")
    print(f"parallel path launches: the sharded run's sidecar's round trip "
          f"{par_codec}")
    for row in rows:
        # B1's rows count on their model's path (the bf16 instances on the
        # bench path's or TBC's bf16 round trip's), B2-B4's on WACNN's
        path = row.pop("path", "cnn")
        row["launches"] = launches[path].get(row["name"], 0)
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never launched on the {path} "
                                 "main path")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
