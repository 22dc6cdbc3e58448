"""Where the port's codec time goes on the card: a full-width WACNN or
STF (`chip_smoke.smoke_model`: seeded random weights) compress +
decompress of two 512x768 images under torch.profiler, after one warm-up
round trip.

    python3 tools/profile_torch_codec.py [--model cnn|stf]
        [--coder lane|host] [--per-slice] [--fused-encode 0|1|split]
        [--trace PREFIX]
    python3 tools/profile_torch_codec.py [--model cnn|stf] --rounds N

Lane compress encodes y on the card (kernel B3), by the per-slice walk
or (--fused-encode 1 or split) a fused encode tier's CUDA-graph replay;
lane decompress is the fused one (one CUDA-graph replay) unless
--per-slice. Prints,
for each call in its own profiler window, the wall time, the device-busy
share (sum of kernel self times over wall time) and device time by
kernel, largest first. With --rounds N it profiles nothing: it times N
warm lane compresses each of the per-slice walk and the full and split
tiers, alternated (host clock around synchronised calls), after each
tier's replay alone (CUDA events), the host's work before it (staging
x through the full tier's pinned buffer, against a fresh `pin_memory()`
of x) and after it (stream assembly with the tails fetch, z coding).
Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="cnn", choices=("cnn", "stf"))
    ap.add_argument("--coder", default="lane", choices=("lane", "host"))
    ap.add_argument("--per-slice", action="store_true",
                    help="lane: decompress with the per-slice walk")
    ap.add_argument("--fused-encode", default="0", choices=("0", "1", "split"),
                    help="lane: compress through a fused encode tier")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", help="write Chrome traces to PREFIX.<call>.json")
    ap.add_argument("--rounds", type=int, default=0,
                    help="time N alternated warm compresses of each lane "
                    "encode path instead of profiling")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from chip_smoke import _device_us, profile_call, smoke_model, smooth_batch
    from stf_tpu_torch.models import Codec

    if not torch.cuda.is_available():
        print("profile_torch_codec: needs a CUDA device", file=sys.stderr)
        return 1
    x = (smooth_batch(args.batch, 512, 768, 0) * 255).round().astype(np.uint8)
    if args.rounds:
        return compare_encode_paths(x, args.rounds, args.model)
    fused_encode = {"0": False, "1": True, "split": "split"}[args.fused_encode]
    codec = Codec(smoke_model(args.model), coder=args.coder,
                  fused_encode=fused_encode)
    codec.fused = not args.per_slice
    enc = codec.compress(x)  # warm-up: cuDNN heuristics, allocator, builds
    codec.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()

    print(f"card: {torch.cuda.get_device_name(0)}; {args.model} coder "
          f"{args.coder}"
          f"{' per-slice' if args.per_slice else ''}"
          f"{f' fused encode {codec._fused_mode}' if codec.fused_encode else ''}; "
          f"batch {args.batch} x 512x768, seed weights")
    # the first profiler window pays the tracer's start-up (hundreds of ms
    # of host time): spend it on an untimed compress
    profile_call(lambda: codec.compress(x), "warm-up")
    # one profiler window per call, so each gets its own busy share
    for name, fn in (
        ("compress", lambda: codec.compress(x)),
        ("decompress", lambda: codec.decompress(enc["strings"], enc["shape"])),
    ):
        wall, busy, kernels = profile_call(
            fn, name, args.trace and f"{args.trace}.{name}.json"
        )
        print(f"{name}: {wall * 1e3:.3f} ms wall, device busy "
              f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%, idle "
              f"{100 * (1 - busy / wall):.1f}%)")
        print(f"{'device ms':>10} {'calls':>6}  kernel")
        for e in sorted(kernels, key=_device_us, reverse=True)[: args.top]:
            print(f"{_device_us(e) / 1e3:10.3f} {e.count:6d}  {e.key[:100]}")
    return 0


def compare_encode_paths(x, rounds, model_name):
    import numpy as np
    import torch

    from chip_smoke import smoke_model
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.models import codec as cm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; {model_name} lane compress of {x.shape[0]} x "
          "512x768, seed weights")
    model = smoke_model(model_name)
    codecs = {"per-slice": Codec(model, coder="lane"),
              "full": Codec(model, coder="lane", fused_encode=True),
              "split": Codec(model, coder="lane", fused_encode="split")}
    for codec in codecs.values():  # capture, self-check, one replay
        codec.compress(x)
        codec.compress(x)

    def call_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def spread(v):
        return (f"median {np.median(v):.3f} ms, quartiles "
                f"{np.percentile(v, 25):.3f}-{np.percentile(v, 75):.3f}")

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode():
        for name in ("full", "split"):
            codec = codecs[name]
            graphs, _, _, out, _ = next(iter(codec._enc_graphs.values()))
            dev = []
            for _ in range(5):
                start.record()
                for graph in graphs:
                    graph.replay()
                end.record()
                end.synchronize()
                dev.append(start.elapsed_time(end))
            counts, hashes, z_tail = cm._split_meta(
                out[0].cpu().numpy(), model.num_slices
            )
            build = [call_ms(lambda: codec._build_lane_stream(
                counts, hashes, *out[1:4], flags=cm._LANE_FLAG_FUSED_ENC
            )) for _ in range(5)]
            print(f"{name} tier: replay device {spread(dev)}; stream "
                  f"assembly after it (tails fetch, host) {spread(build)}")
        _, statics, staging, out, _ = next(
            iter(codecs["full"]._enc_graphs.values()))
        xt = torch.from_numpy(x)
        stage = [call_ms(lambda: statics[0].copy_(staging[0].copy_(xt),
                                                  non_blocking=True))
                 for _ in range(5)]
        fresh = [call_ms(lambda: statics[0].copy_(xt.pin_memory(),
                                                  non_blocking=True))
                 for _ in range(5)]
        print(f"staging x (host to card): through the kept pinned buffer "
              f"{spread(stage)}; through a fresh pin_memory() {spread(fresh)}")
        z_sym = out[4]
        z_np = z_tail[1:].view(np.int8)[:z_sym.numel()].reshape(
            z_sym.shape[0], z_sym.shape[2], z_sym.shape[3], -1)
        z_ms = [call_ms(lambda: codecs["full"].eb_coder.compress_symbols(z_np))
                for _ in range(5)]
        print(f"z coding (host) {spread(z_ms)}")
    walls = {name: [] for name in codecs}
    for _ in range(rounds):
        for name, codec in codecs.items():
            walls[name].append(call_ms(lambda: codec.compress(x)))
    for name, v in walls.items():
        won = ""
        if name != "per-slice":
            wins = sum(a < b for a, b in zip(v, walls["per-slice"]))
            won = f"; faster than the per-slice call of its round {wins} of {rounds}"
        print(f"warm {name} compress: {spread(v)}{won}; all "
              f"{[round(t, 3) for t in v]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
