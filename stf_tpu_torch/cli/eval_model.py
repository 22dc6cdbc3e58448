"""Evaluate a codec end to end on an image directory (port of
`stf_tpu/cli/eval_model.py`):

    python -m stf_tpu_torch.cli.eval_model -a cnn \
        -p ckpt/checkpoint_best.pth.tar -d /path/kodak [--device cpu]

Pads each image to a multiple of 64 (centred), runs real compress and
decompress (or --entropy-estimation for the theoretical bpp of the eval
forward), and prints the averaged PSNR / MS-SSIM / bpp / encode and
decode seconds an image as the JAX CLI's JSON document. Images of one
padded shape share the codec's CUDA graphs: the first batch of each
padded batch shape runs once cold (the graphs' capture, a fused tier's
self-check), reported as first_use_encoding_time /
first_use_decoding_time, and then once timed warm. `--batch-size N`
codes same-shape images together (per-image times are the batch's over
N).

Differences from the JAX CLI: `--device` (default cuda; raises where
there is no card, never falls back to the CPU); checkpoints are torch
files (`stf_tpu_torch.zoo.load_checkpoint`: the port's own, the
trainer's and reference `.pth.tar` files), not flax msgpack; `eval_model`
takes the model, which holds its weights, where the JAX function takes
(model, params); a reconstruction that cannot be written raises; there
is no compile cache to enable (`_native` keeps its nvcc builds on disk);
`--profile-dir` writes a `torch.profiler` trace.
"""

import argparse
import collections
import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

import stf_tpu_torch
from ..ans.lane_coder import fixed_overhead_bytes
from ..datasets import load_image
from ..models import Codec
from ..models.codec import default_device, half_weights, resolve_device
from ..utils.metrics import ms_ssim
from ..zoo import load_checkpoint

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


def collect_images(rootpath):
    return sorted(
        os.path.join(rootpath, f)
        for f in os.listdir(rootpath)
        if os.path.splitext(f)[-1].lower() in IMG_EXTENSIONS
    )


def pad_to_multiple(x: np.ndarray, p: int = 64):
    """Zero-pad NHWC to the next multiple of p, centred (reference
    `__main__.py:88-101`); returns the padded array and the image's box
    (top, left, height, width) in it."""
    h, w = x.shape[1:3]
    new_h = (h + p - 1) // p * p
    new_w = (w + p - 1) // p * p
    left = (new_w - w) // 2
    top = (new_h - h) // 2
    pads = (
        (0, 0),
        (top, new_h - h - top),
        (left, new_w - w - left),
        (0, 0),
    )
    return np.pad(x, pads), (top, left, h, w)


def unpad(x, box):
    top, left, h, w = box
    return x[:, top : top + h, left : left + w, :]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _compress(codec: Codec, batch, prefetch=None):
    out = codec.compress(batch, prefetch=prefetch)
    # compress returns host bytes built from device results it fetched, so
    # its own device work is done when it returns; a fused tier's first
    # call, though, self-checks its stream with a decompress whose
    # synthesis it leaves queued. The encode window ends after all of it.
    _sync(codec.device)
    return out


def _decompress(codec: Codec, out_enc):
    """(x_hat on the device, x_hat on the host). The decode window ends
    with x_hat on the host, as the JAX CLI's `np.asarray(x_hat)` ends it:
    decompress returns while the device still runs the synthesis."""
    x_hat = codec.decompress(out_enc["strings"], out_enc["shape"])["x_hat"]
    return x_hat, x_hat.float().cpu().numpy()


def _timed(fn, *args):
    start = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - start


def inference(codec: Codec, xs, warm_shapes: set, batch=None, boxes=None,
              prefetch=None):
    """Encode and decode a batch of same-shape images (xs: list of (1, H,
    W, 3) float arrays); returns per-image (metrics, reconstruction).
    Per-image times are the batch's divided by its size.

    `batch`/`boxes` let the caller hand in a padded batch (a host array or
    a tensor already on the device); `prefetch` goes to the timed
    `codec.compress`, which calls it once its device work is queued, so
    the next batch's upload overlaps this batch's coding."""
    if batch is None:
        padded, boxes = zip(*[pad_to_multiple(x) for x in xs])
        batch = np.concatenate(padded, axis=0)
    n = batch.shape[0]

    cold_enc = cold_dec = None
    if tuple(batch.shape) not in warm_shapes:
        # the cold call captures this shape's graphs (and runs a fused
        # tier's self-check) outside the warm timer; its own time is
        # reported as first use
        out_enc, cold_enc = _timed(_compress, codec, batch)
        _, cold_dec = _timed(_decompress, codec, out_enc)
        cold_enc, cold_dec = cold_enc / n, cold_dec / n
        warm_shapes.add(tuple(batch.shape))

    out_enc, enc_time = _timed(_compress, codec, batch, prefetch)
    (x_hat_dev, x_hat_batch), dec_time = _timed(_decompress, codec, out_enc)
    enc_time, dec_time = enc_time / n, dec_time / n

    # host coder: y-streams are per image (exact per-image bpp, the
    # reference CLI's batch-1 contract). lane coder: the batch shares one
    # stream, its bytes shared out equally (the mean exact, each image's
    # approximate), and the fixed per-segment framing is reported as
    # lane_framing_bpp (use the host coder for RD curves)
    y_list = out_enc["strings"][0]
    z_bytes = [len(s) for s in out_enc["strings"][1]]
    if len(y_list) == n:
        y_bytes = [len(s) for s in y_list]
    else:
        y_bytes = [sum(len(s) for s in y_list) / n] * n
    lane_overhead = 0.0
    if codec.coder == "lane":
        S = codec.model.num_slices
        K = len(codec._sub_batches(n))
        lane_overhead = (4 + 4 * S * K + fixed_overhead_bytes(S * K)) / n

    results = []
    for i, (x, box) in enumerate(zip(xs, boxes)):
        x_hat = unpad(x_hat_batch[i : i + 1], box)
        num_pixels = x.shape[1] * x.shape[2]
        mse = float(np.mean((x - x_hat) ** 2))
        x_dev = torch.from_numpy(x).to(codec.device)
        rv = {
            "psnr": -10 * math.log10(mse),
            "ms-ssim": float(ms_ssim(
                x_dev, unpad(x_hat_dev[i : i + 1], box).float()
            )),
            "bpp": (y_bytes[i] + z_bytes[i]) * 8.0 / num_pixels,
            "encoding_time": enc_time,
            "decoding_time": dec_time,
        }
        if lane_overhead:
            rv["lane_framing_bpp"] = lane_overhead * 8.0 / num_pixels
        if cold_enc is not None:
            rv["first_use_encoding_time"] = cold_enc
            rv["first_use_decoding_time"] = cold_dec
        results.append((rv, x_hat))
    return results


def inference_entropy_estimation(model, x: np.ndarray, device: torch.device):
    """The eval forward's rate (the likelihoods' bits over the unpadded
    pixels) and the PSNR of its clipped, unpadded x_hat; the forward's
    time is halved into encode and decode, as the JAX CLI reports it."""
    x_padded, box = pad_to_multiple(x)
    x_dev = torch.from_numpy(x_padded).to(device)
    _sync(device)
    start = time.perf_counter()
    with torch.inference_mode():
        out = model(x_dev)
        _sync(device)
    elapsed = time.perf_counter() - start

    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    bpp = sum(
        float(torch.log(lik).sum() / (-math.log(2) * num_pixels))
        for lik in out["likelihoods"].values()
    )
    x_hat = unpad(np.clip(out["x_hat"].float().cpu().numpy(), 0, 1), box)
    mse = float(np.mean((x - x_hat) ** 2))
    return {
        "psnr": -10 * math.log10(mse),
        "bpp": bpp,
        "encoding_time": elapsed / 2.0,
        "decoding_time": elapsed / 2.0,
    }, x_hat


class _Upload:
    """The next batch's upload, started while the current batch codes:
    on the card from pinned memory, non-blocking, on a side stream. The
    stream that codes the batch must wait for that copy before it reads
    it (`take`); without the wait it would read a half-copied batch."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.pending = None

    def start(self, batch: np.ndarray) -> None:
        x = torch.from_numpy(batch)
        if self.stream is None:
            self.pending = x
            return
        x = x.pin_memory()
        with torch.cuda.stream(self.stream):
            self.pending = x.to(self.device, non_blocking=True)

    def take(self):
        """The uploaded batch, safe to read on the current stream, or None
        when no upload was started."""
        x, self.pending = self.pending, None
        if x is not None and self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            # the allocator must not hand x's memory to the side stream
            # while the current stream still reads it
            x.record_stream(current)
        return x


def eval_model(
    model,
    filepaths,
    entropy_estimation=False,
    recon_path="reconstruction",
    verbose=False,
    half=False,
    batch_size=1,
    backend="host",
    fused_encode=False,
    transform_chunks=1,
    pipeline=1,
    prefetch=False,
    device=None,
):
    """The averaged metrics of `model` over `filepaths`, reconstructions
    written to `recon_path` (uint8 PNGs, x * 255 + 0.5; a failed write
    raises, where the JAX CLI skips the image). `device=None` is the card.

    `half`: real coding uses `Codec(dtype=torch.bfloat16)` (a bf16
    analysis over an f32 walk and synthesis, the entropy bottleneck f32 so
    the CDF tables stay exact). With `entropy_estimation` it runs the
    eval forward as the JAX CLI's parameters cast to bf16 run it: flax
    promotes every layer to the f32 image's dtype, so it computes in f32
    on bf16-rounded weights (`half_weights`, the bottleneck's included),
    and B1 runs in f32."""
    device = default_device() if device is None else torch.device(device)
    metrics = collections.defaultdict(float)
    counts = collections.defaultdict(int)
    os.makedirs(recon_path, exist_ok=True)

    def save_recon(path, x_hat):
        from PIL import Image

        Image.fromarray(
            (np.clip(x_hat[0], 0, 1) * 255 + 0.5).astype(np.uint8)
        ).save(os.path.join(recon_path, os.path.basename(path)))

    if entropy_estimation:
        model = (half_weights(model, torch.bfloat16, device, bottleneck=True)
                 if half else model.to(device).eval())
        for f in filepaths:
            if verbose:
                print(f, file=sys.stderr)
            x = load_image(f)[None]
            rv, x_hat = inference_entropy_estimation(model, x, device)
            save_recon(f, x_hat)
            for k, v in rv.items():
                metrics[k] += v
        return {k: v / len(filepaths) for k, v in metrics.items()}

    codec = Codec(
        model, coder=backend, device=device,
        dtype=torch.bfloat16 if half else None,
        fused_encode=fused_encode,
        pipeline=pipeline,
        analyze_chunks=transform_chunks,
        synth_chunks=transform_chunks,
    )
    warm_shapes: set = set()
    # same-shape images in batches, flattened into one list so that batch
    # i + 1's upload can overlap batch i's coding (--prefetch)
    groups = collections.defaultdict(list)
    for f in filepaths:
        x = load_image(f)[None]
        groups[x.shape].append((f, x))
    batches = []
    for items in groups.values():
        for lo in range(0, len(items), batch_size):
            chunk = items[lo : lo + batch_size]
            padded, boxes = zip(*[pad_to_multiple(x) for _, x in chunk])
            batches.append((chunk, np.concatenate(padded, 0), boxes))
    upload = _Upload(device) if prefetch else None
    for i, (chunk, batch_np, boxes) in enumerate(batches):
        if verbose:
            for f, _ in chunk:
                print(f, file=sys.stderr)
        hook = None
        if upload is not None and i + 1 < len(batches):
            hook = lambda n_=batches[i + 1][1]: upload.start(n_)  # noqa: E731
        x_in = upload.take() if upload is not None else None
        results = inference(
            codec, [x for _, x in chunk], warm_shapes,
            batch=batch_np if x_in is None else x_in, boxes=boxes,
            prefetch=hook,
        )
        for (f, _), (rv, x_hat) in zip(chunk, results):
            save_recon(f, x_hat)
            for k, v in rv.items():
                metrics[k] += v
                counts[k] += 1

    return {k: v / counts[k] for k, v in metrics.items()}


def setup_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("-r", "--recon_path", type=str, default="reconstruction")
    p.add_argument("-a", "--architecture", type=str, required=True)
    p.add_argument(
        "-c",
        "--entropy-coder",
        choices=stf_tpu_torch.available_entropy_coders(),
        default=stf_tpu_torch.available_entropy_coders()[0],
    )
    p.add_argument("--entropy-estimation", action="store_true")
    p.add_argument(
        "--batch-size",
        type=int,
        default=1,
        help="encode/decode same-shape images together (per-image times "
        "are batch time / batch size)",
    )
    p.add_argument(
        "--half",
        action="store_true",
        help="bfloat16 analysis (the reference's fp16 option): real coding "
        "through Codec(dtype=torch.bfloat16); with --entropy-estimation, "
        "the forward in f32 on bf16-rounded weights",
    )
    p.add_argument(
        "--backend",
        choices=("host", "lane"),
        default="host",
        help="y-latent entropy backend: 'host' = reference-contract CPU "
        "rANS with per-image streams (use this for RD curves); 'lane' = "
        "interleaved rANS encoded and decoded on the card (kernels B3 and "
        "B2) with a fused decompress (throughput mode: its bpp includes "
        "fixed per-segment framing, reported as lane_framing_bpp)",
    )
    p.add_argument(
        "--fused-encode",
        nargs="?",
        const="1",
        default="0",
        choices=("0", "1", "split"),
        help="lane backend only: encode through one CUDA-graph replay (1 = "
        "the whole encode; split = eager transforms and one replay of the "
        "walk, the tier a failed self-check of 1 demotes to). Streams are "
        "byte-identical (header flag aside); oversized or overflowing "
        "inputs fall back to the per-slice walk",
    )
    p.add_argument(
        "--transform-chunks",
        type=int,
        default=1,
        help="run analysis and synthesis over the batch in this many "
        "sequential sub-batches (shrinks peak memory at a large "
        "--batch-size; ignored when the batch is not divisible)",
    )
    p.add_argument(
        "--pipeline",
        type=int,
        default=1,
        help="split the channel-AR walk into this many sub-batches (part "
        "of the LANE stream layout: decode needs the same value)",
    )
    p.add_argument(
        "--prefetch",
        action="store_true",
        help="upload batch i+1 to the card while batch i codes (pinned "
        "memory, a side stream, the codec's prefetch hook)",
    )
    p.add_argument(
        "--profile-dir",
        type=str,
        default=None,
        help="write a torch.profiler trace of the eval into this directory",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument(
        "-p", "--path", dest="paths", type=str, nargs="*", required=True
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device (default cuda, which raises where there is no "
        "card; cpu runs the plain versions of the kernels)",
    )
    return p


def _profiler(profile_dir, device):
    if not profile_dir:
        return contextlib.nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir),
    )


def main(argv=None):
    args = setup_args().parse_args(argv)
    filepaths = collect_images(args.dataset)
    if not filepaths:
        print("Error: no images found in directory.", file=sys.stderr)
        sys.exit(1)

    stf_tpu_torch.set_entropy_coder(args.entropy_coder)
    device = resolve_device(args.device)

    results = collections.defaultdict(list)
    with _profiler(args.profile_dir, device):
        for run in args.paths:
            model = load_checkpoint(run, args.architecture, device=device)
            metrics = eval_model(
                model,
                filepaths,
                args.entropy_estimation,
                args.recon_path,
                args.verbose,
                half=args.half,
                batch_size=args.batch_size,
                backend=args.backend,
                fused_encode={
                    "0": False, "1": True, "split": "split"
                }[args.fused_encode],
                transform_chunks=args.transform_chunks,
                pipeline=args.pipeline,
                prefetch=args.prefetch,
                device=device,
            )
            for k, v in metrics.items():
                results[k].append(v)

    description = (
        "entropy estimation" if args.entropy_estimation else args.entropy_coder
    )
    print(
        json.dumps(
            {
                "name": args.architecture,
                "description": f"Inference ({description})",
                "results": dict(results),
            },
            indent=2,
        )
    )


if __name__ == "__main__":
    main()
