#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`stf_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card, its power limit, and the torch / CUDA versions;
  2. build both CUDA kernels (nvcc, sm_90a) and the rANS library from the
     sources in this checkout, all compilers started at once;
  3. kernel B1 (window attention) against its plain PyTorch version at
     WACNN's two attention geometries for batch 2 with shift labels;
  4. kernel B2 (lane-rANS decode) against its plain version and the
     encoded symbols, on a seeded 1,179,648-symbol stream with escapes
     (one Kodak-size slice at batch 24);
  5. the slice end to end: a full-width WACNN (N=192, M=320, 10 slices)
     with seeded random weights compresses and decompresses two 512x768
     uint8 images with coder="lane" and coder="host"; decoded symbols
     must equal the encoded ones, the two x_hat must be bit-equal, and
     each kernel's launch count over this run must match the path.

It prints the kernels' JSON line, then the card's name and power limit as
nvidia-smi gives them, and last one JSON line {"ok": true, "device": ...}.
Times are CUDA-event means (kernels) or host clocks around synchronised
work (codec); bounds use the H100 SXM data-sheet rates (3.35 TB/s,
67 TFLOP/s f32 without tensor cores).
"""

import json
import os
import subprocess
import sys
import time

SEED = 0
BATCH, HEIGHT, WIDTH = 2, 512, 768
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ATTN_TOL = 1e-5


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


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_attention(dev):
    """B1 vs its plain version and SDPA at WACNN's two geometries."""
    import torch
    import torch.nn.functional as F

    from stf_tpu_torch.layers import attention_core as ac
    from stf_tpu_torch.layers import shifted_window_region_labels

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    # (feature map, channels, window): g_a/g_s blocks at 512x768 input
    for (h, w), C, ws in (((128, 192), 192, 8), ((32, 48), 320, 4)):
        nh, N = 8, ws * ws
        hd = C // nh
        scale = hd ** -0.5
        qkv = torch.randn(BATCH, h, w, 3 * C, device=dev, generator=gen)
        bias = torch.randn(nh, N, N, device=dev, generator=gen)
        labels = torch.from_numpy(
            shifted_window_region_labels(h, w, ws, ws // 2)
        ).to(dev)
        out = ac.window_attention(qkv, bias, labels, ws, scale)
        plain = ac.window_attention_plain(qkv, bias, labels, ws, scale)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"B1 ws={ws}: max abs err {err} > {ATTN_TOL}")
        q, k, v = ac.partition_qkv(qkv, ws, nh)
        nW = labels.shape[0]
        mask = (bias[None, None] + ac.shift_penalty(labels)[None, :, None])
        mask = mask.expand(BATCH, nW, nh, N, N).reshape(-1, nh, N, N)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, scale=scale
        )
        lib_err = (ac.unpartition(sdpa(), BATCH, h, w, ws) - out).abs().max().item()
        ms = cuda_ms(lambda: ac.window_attention(qkv, bias, labels, ws, scale), 50)
        plain_ms = cuda_ms(
            lambda: ac.window_attention_plain(qkv, bias, labels, ws, scale), 10
        )
        lib_ms = cuda_ms(sdpa, 50)
        nbytes = (qkv.numel() + out.numel() + bias.numel() + labels.numel()) * 4
        ops = 4 * N * N * hd * BATCH * nW * nh
        bound_ms, bound_by = bound(nbytes, ops)
        name = f"window_attention_ws{ws}_hd{hd}"
        print(f"B1 {name}: qkv {tuple(qkv.shape)} max_abs_err {err:.3g} "
              f"(sdpa {lib_err:.3g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"sdpa {lib_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})")
        rows.append(dict(
            name=name, route="cuda",
            source="stf_tpu_torch/csrc/window_attention.cu",
            replaces="stf_tpu/layers/pallas_attention.py:49",
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
        ))
    return rows


def phase_lane_decode(dev):
    """B2 vs its plain version and the encoded symbols."""
    import numpy as np
    import torch

    from stf_tpu_torch.ans import lane_coder as lc
    from stf_tpu_torch.entropy import build_gc_tables, get_scale_table
    from stf_tpu_torch.models.codec import _bucket

    n = 49152 * 24
    scales = get_scale_table()
    tables = lc.truncate_tables(*build_gc_tables(scales).astuple(), max_half=62)
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, 48, n).astype(np.int32)
    sym = np.rint(rng.normal(0, scales[idx] * 0.7)).astype(np.int32)
    esc = rng.random(n) < 0.01  # forced escapes beyond the ±62 window
    sym[esc] = rng.integers(63, 3000, int(esc.sum())) * rng.choice([-1, 1], int(esc.sum()))
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
    out = lc.lane_decode(*args)
    plain = lc.lane_decode_plain(*args)
    torch.cuda.synchronize()
    got = out.cpu().numpy()
    if not np.array_equal(got, sym):
        raise AssertionError(f"B2 decode differs from the encoded symbols at "
                             f"{int((got != sym).sum())} of {n}")
    if not np.array_equal(plain.cpu().numpy(), sym):
        raise AssertionError("B2 plain version differs from the encoded symbols")
    ms = cuda_ms(lambda: lc.lane_decode(*args), 20)
    plain_ms = cuda_ms(lambda: lc.lane_decode_plain(*args), 1)
    stream_bytes = 2 * int(stream.word_counts.sum()) + 4 * int(stream.side_counts.sum())
    nbytes = 8 * n + stream_bytes + 4 * stream.states.size + 4 * tables.cdf.size
    # ~30 integer operations per symbol: 7-step search, update, renorm, ranks
    bound_ms, bound_by = bound(nbytes, 30 * n)
    tg = lc.rows_per_group(n)
    print(f"B2 lane_decode: n {n} escapes {int(esc.sum())} stream {stream_bytes} B "
          f"(host encode {enc_s:.3f} s) exact; kernel {ms:.4f} ms plain "
          f"{plain_ms:.2f} ms bound {bound_ms:.4f} ms ({bound_by}); serial "
          f"chain {tg} rows/group")
    return [dict(
        name="lane_decode", route="cuda",
        source="stf_tpu_torch/csrc/lane_decode.cu",
        replaces="stf_tpu/ans/lane_coder.py:495",
        launches=None, max_abs_err=0, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )]


def phase_codec(dev):
    """The main path: full-width WACNN lane and host round trips."""
    import numpy as np
    import torch

    from stf_tpu_torch import _native
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.utils import psnr
    from stf_tpu_torch.zoo import create_model

    x = (smooth_batch(BATCH, HEIGHT, WIDTH, SEED) * 255).round().astype(np.uint8)
    model = create_model("cnn", seed=SEED)
    lane = Codec(model, coder="lane", device=dev)
    host = Codec(model, coder="host", device=dev)
    counts = _native.launch_counts

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def delta(before):
        return {k: v - before.get(k, 0) for k, v in counts.items()
                if v - before.get(k, 0)}

    counts.clear()  # the main path starts here
    steps = {}
    snap = dict(counts)
    enc, enc_s = timed(lane.compress, x)
    steps["lane compress"] = delta(snap)
    snap = dict(counts)
    dec, dec_s = timed(lane.decompress, enc["strings"], enc["shape"])
    steps["lane decompress"] = delta(snap)
    snap = dict(counts)
    henc, henc_s = timed(host.compress, x)
    steps["host compress"] = delta(snap)
    snap = dict(counts)
    hdec, hdec_s = timed(host.decompress, henc["strings"], henc["shape"])
    steps["host decompress"] = delta(snap)
    launches = dict(counts)  # the main path ends here
    for step, d in steps.items():
        print(f"launches in {step}: {d}")

    S = model.num_slices
    for i, (s, d) in enumerate(zip(enc["symbols"], dec["symbols"])):
        if not np.array_equal(s, d.cpu().numpy()):
            raise AssertionError(f"lane: slice {i} decoded symbols differ")
    for i, (s, d) in enumerate(zip(henc["symbols"], hdec["symbols"])):
        if not np.array_equal(s, d.cpu().numpy()):
            raise AssertionError(f"host: slice {i} decoded symbols differ")
    if not all(np.array_equal(a, b) for a, b in zip(enc["symbols"], henc["symbols"])):
        raise AssertionError("lane and host walks quantized different symbols")
    if not torch.equal(dec["x_hat"], hdec["x_hat"]):
        raise AssertionError("lane and host x_hat are not bit-equal")
    x_hat = dec["x_hat"]
    if x_hat.shape != (BATCH, HEIGHT, WIDTH, 3) or not torch.isfinite(x_hat).all():
        raise AssertionError(f"x_hat shape {tuple(x_hat.shape)} or values bad")
    # the decoded image against the model's own eval forward on x
    xf = torch.from_numpy(x).to(dev).float() / 255.0
    with torch.inference_mode():
        ref = model(xf)["x_hat"].clamp(0, 1)
    fwd_err = (ref - x_hat).abs().max().item()
    if not fwd_err <= 1e-3:
        raise AssertionError(f"codec x_hat vs eval forward: {fwd_err}")

    b1 = {k: v for k, v in launches.items() if k.startswith("window_attention")}
    for step, want in (("lane compress", 2), ("lane decompress", 2),
                       ("host compress", 2), ("host decompress", 2)):
        got = sum(v for k, v in steps[step].items() if k.startswith("window_attention"))
        if got != want:
            raise AssertionError(f"B1 launched {got} times in {step}, want {want}")
    if steps["lane decompress"].get("lane_decode", 0) != S:
        raise AssertionError(f"B2 launched {steps['lane decompress']} in lane decompress")
    if len(b1) != 2 or launches.get("lane_decode", 0) != S:
        raise AssertionError(f"launch counts {launches}")

    pixels = BATCH * HEIGHT * WIDTH
    lane_bytes = sum(map(len, enc["strings"][0])) + sum(map(len, enc["strings"][1]))
    host_bytes = sum(map(len, henc["strings"][0])) + sum(map(len, henc["strings"][1]))
    p = psnr(x_hat, xf).item()
    print(f"codec (seed weights, not an operating point): {BATCH}x{HEIGHT}x{WIDTH} "
          f"lane {lane_bytes * 8 / pixels:.4f} bpp host {host_bytes * 8 / pixels:.4f} "
          f"bpp PSNR {p:.3f} dB; lane encode {enc_s:.3f} s decode {dec_s:.3f} s; "
          f"host encode {henc_s:.3f} s decode {hdec_s:.3f} s (first calls); "
          f"eval-forward max diff {fwd_err:.3g}")
    enc2, enc2_s = timed(lane.compress, x)
    _, dec2_s = timed(lane.decompress, enc2["strings"], enc2["shape"])
    print(f"codec repeat: lane encode {enc2_s:.3f} s decode {dec2_s:.3f} s")
    return launches


def main():
    import torch

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
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | {smi} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda}")

    from stf_tpu_torch import _native

    t0 = time.perf_counter()
    _native.build_all(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(_native.CUDA_LIBS))} with nvcc sm_90a, rans with g++)")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    rows = phase_attention(dev) + phase_lane_decode(dev)
    launches = phase_codec(dev)
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never launched on the main path")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
