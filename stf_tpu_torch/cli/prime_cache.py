"""Warm a codec's shape buckets before its first real request (port of
`stf_tpu/cli/prime_cache.py`):

    python -m stf_tpu_torch.cli.prime_cache -a cnn -p ckpt.pth.tar \
        --shapes 512x768,768x512 --batch-sizes 1,24 [--device cpu]

What persists and what does not: on the card, `main` first builds every
CUDA kernel and the rANS library (`_native.build_all()`); those builds
are written to disk and outlive the process, so a later process loads
them instead of running nvcc. The warm-up then runs a full compress and
decompress on zeros for each (batch, H, W) bucket (inputs pad to x64,
`eval_model.pad_to_multiple`), which captures the codec's CUDA graphs for
that shape and runs a fused tier's self-check. Those graphs live only as
long as the process and its codec: `prime` is what a long-lived process
calls on its codec before its first request. Each bucket's first-use
seconds are printed. The zeros are float32, the dtype `eval_model` feeds
(a fused tier's graph is per input dtype), where the JAX CLI primes
uint8.
"""

import argparse
import sys
import time

import numpy as np


def prime(codec, shapes, batch_sizes):
    """Run compress + decompress on float32 zeros for every (batch, H, W)
    bucket, printing each bucket's first-use seconds."""
    import torch

    for bs in batch_sizes:
        for h, w in shapes:
            t0 = time.perf_counter()
            batch = np.zeros((bs, h, w, 3), np.float32)
            out = codec.compress(batch)
            codec.decompress(out["strings"], out["shape"])
            if codec.device.type == "cuda":
                torch.cuda.synchronize(codec.device)
            print(
                f"primed ({bs}, {h}, {w}, 3) in "
                f"{time.perf_counter() - t0:.1f}s",
                file=sys.stderr,
            )


def parse_shapes(spec):
    shapes = []
    for part in spec.split(","):
        h, w = part.lower().split("x")
        h, w = int(h), int(w)
        if h % 64 or w % 64:
            raise ValueError(
                f"shape {part} is not a x64 bucket (inputs pad to x64)"
            )
        shapes.append((h, w))
    return shapes


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--architecture", type=str, required=True)
    p.add_argument("-p", "--path", type=str, required=True)
    p.add_argument(
        "--shapes",
        type=str,
        default="512x768,768x512",
        help="comma-separated HxW padded buckets (multiples of 64)",
    )
    p.add_argument(
        "--batch-sizes", type=str, default="1",
        help="comma-separated batch sizes to prime",
    )
    p.add_argument(
        "--half", action="store_true", help="prime the bfloat16 codec"
    )
    p.add_argument(
        "--backend",
        choices=("host", "lane"),
        default="host",
        help="entropy backend to prime (mirror of eval_model --backend; "
        "'lane' also captures the fused decompress)",
    )
    p.add_argument(
        "--fused-encode",
        nargs="?",
        const="1",
        default="0",
        choices=("0", "1", "split"),
        help="prime the fused encode tier (1 = full, split = split; mirror "
        "of eval_model --fused-encode)",
    )
    p.add_argument(
        "--transform-chunks", type=int, default=1,
        help="mirror of eval_model --transform-chunks",
    )
    p.add_argument(
        "--pipeline", type=int, default=1,
        help="mirror of eval_model --pipeline",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device (default cuda, which raises where there is no "
        "card)",
    )
    args = p.parse_args(argv)

    import torch

    from .. import _native
    from ..models import Codec
    from ..models.codec import resolve_device
    from ..zoo import load_checkpoint

    device = resolve_device(args.device)
    if device.type == "cuda":
        _native.build_all()
    model = load_checkpoint(args.path, args.architecture, device=device)
    codec = Codec(
        model, coder=args.backend, device=device,
        dtype=torch.bfloat16 if args.half else None,
        fused_encode={"0": False, "1": True, "split": "split"}[
            args.fused_encode
        ],
        pipeline=args.pipeline,
        analyze_chunks=args.transform_chunks,
        synth_chunks=args.transform_chunks,
    )
    prime(
        codec,
        parse_shapes(args.shapes),
        [int(b) for b in args.batch_sizes.split(",")],
    )


if __name__ == "__main__":
    main()
