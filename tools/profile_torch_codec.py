"""Where the port's codec time goes on the card: full-width WACNN
(seeded random weights) compress + decompress of two 512x768 images
under torch.profiler, after one warm-up round trip.

    python3 tools/profile_torch_codec.py [--coder lane|host] [--per-slice]
        [--trace PREFIX]

Lane compress encodes y on the card (kernel B3); lane decompress is the
fused one (one CUDA-graph replay) unless --per-slice. Prints,
for each call in its own profiler window, the wall time, the device-busy
share (sum of kernel self times over wall time) and device time by
kernel, largest first. Needs a CUDA card.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coder", default="lane", choices=("lane", "host"))
    ap.add_argument("--per-slice", action="store_true",
                    help="lane: decompress with the per-slice walk")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", help="write Chrome traces to PREFIX.<call>.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import smooth_batch
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    if not torch.cuda.is_available():
        print("profile_torch_codec: needs a CUDA device", file=sys.stderr)
        return 1
    x = (smooth_batch(args.batch, 512, 768, 0) * 255).round().astype(np.uint8)
    codec = Codec(create_model("cnn", seed=0), coder=args.coder)
    codec.fused = not args.per_slice
    enc = codec.compress(x)  # warm-up: cuDNN heuristics, allocator, builds
    codec.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()

    print(f"card: {torch.cuda.get_device_name(0)}; coder {args.coder}"
          f"{' per-slice' if args.per_slice else ''}; "
          f"batch {args.batch} x 512x768, seed weights")
    # the first profiler window pays the tracer's start-up (hundreds of ms
    # of host time): spend it on an untimed compress
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        codec.compress(x)
        torch.cuda.synchronize()
    # one profiler window per call, so each gets its own busy share
    for name, fn in (
        ("compress", lambda: codec.compress(x)),
        ("decompress", lambda: codec.decompress(enc["strings"], enc["shape"])),
    ):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(name):
                fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device events, minus the GPU-side range of the annotation
        kernels = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0 and e.key != name
        ]
        busy = sum(_device_us(e) for e in kernels) / 1e6
        print(f"{name}: {wall * 1e3:.3f} ms wall, device busy "
              f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%, idle "
              f"{100 * (1 - busy / wall):.1f}%)")
        print(f"{'device ms':>10} {'calls':>6}  kernel")
        for e in sorted(kernels, key=_device_us, reverse=True)[: args.top]:
            print(f"{_device_us(e) / 1e3:10.3f} {e.count:6d}  {e.key[:100]}")
        if args.trace:
            prof.export_chrome_trace(f"{args.trace}.{name}.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
