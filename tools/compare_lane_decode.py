"""Kernel B2 (lane-rANS decode) against an earlier build of itself and
against builds of its own source with other compile-time settings, each
in device time over CUDA-graph replays, at the main path's slice
(98,304 symbols), at 1,179,648 symbols and at 1024 (one row a group: the
launch's fixed cost). It first prints the card's dependent shared-load
and integer latencies (tools/csrc/latency_probe.cu), the inputs of a
chain floor.

    mkdir -p .smoke_checkout
    git show <rev>:stf_tpu_torch/csrc/lane_decode.cu \\
        > .smoke_checkout/lane_decode_before.cu
    python3 tools/compare_lane_decode.py \\
        [--before .smoke_checkout/lane_decode_before.cu] \\
        [--variant CHUNK=32,PRE=2 ...]

`--before` is a copy of an earlier `lane_decode.cu` with the same C
interface (`stf_lane_decode`). Each `--variant` builds the current source
with `LANE_DECODE_<NAME>` set to each value. Every build is checked
symbol for symbol against the encoded symbols and `lane_decode_plain`,
then timed by `chip_smoke.graph_ms` in two passes, the second in reverse
order, so that a drift of the card's clocks shows as a difference between
the passes. Needs a CUDA card.
"""

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(tag, source, defines=(), name="lanedecode"):
    """Build `source` with `-D` defines into stf_tpu_torch/build/ and load
    it with the declarations of the native library `name`; nvcc's output
    goes to `_native.build_logs[f"{name}_{tag}"]`."""
    from stf_tpu_torch import _native

    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, f"lib{name}_{tag}.so")
    cmd = _native._command(name, out)
    cmd[-1:] = [f"-D{d}" for d in defines] + [source]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"{tag}: build failed\n{done.stdout}{done.stderr}")
    _native.build_logs[f"{name}_{tag}"] = done.stdout + done.stderr
    lib = ctypes.CDLL(out)
    _native._declarations[name](lib)
    return lib


def dependent_latencies():
    """(shared load, multiply-add) cycles each, from tools/csrc/
    latency_probe.cu: 4096-long dependent chains timed by clock64() on one
    thread (the loop's own instructions, unrolled 16 times, included)."""
    import torch

    from stf_tpu_torch import _native

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, "liblatencyprobe.so")
    cmd = _native._command("lanedecode", out)
    cmd[-1] = os.path.join(here, "csrc", "latency_probe.cu")
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    lib.stf_latency_probe.restype = ctypes.c_int
    lib.stf_latency_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    iters = 4096
    res = torch.zeros(3, dtype=torch.int64, device="cuda")
    for _ in range(2):  # the second run, warm
        rc = lib.stf_latency_probe(res.data_ptr(), iters, 3, 1,
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"latency probe launch failed: error {rc}")
        torch.cuda.synchronize()
    lds, mad, _ = res.tolist()
    return lds / iters, mad / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", help="an earlier lane_decode.cu to time beside")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: LANE_DECODE_<NAME> settings")
    ap.add_argument("--replays", type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from chip_smoke import (LANE_BIG_N, LANE_MAIN_N, graph_ms, lane_decode_case,
                            lane_decode_floor, sm_clock_mhz)
    from stf_tpu_torch import _native
    from stf_tpu_torch.ans import lane_coder as lc

    if not torch.cuda.is_available():
        print("compare_lane_decode: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sm_mhz = sm_clock_mhz()
    print(f"card: {smi}, max SM clock {sm_mhz:g} MHz")
    lds, mad = dependent_latencies()
    print(f"dependent latency (tools/csrc/latency_probe.cu): shared load "
          f"{lds:.1f} cycles, integer multiply-add {mad:.1f} cycles")
    dev = torch.device("cuda")
    libs = [("kernel", _native.load("lanedecode"))]
    if args.before:
        libs.append(("before", build("before", args.before)))
    for spec in args.variant:
        defines = [f"LANE_DECODE_{d}" for d in spec.split(",")]
        tag = spec.replace("=", "").replace(",", "_").lower()
        libs.append((spec, build(tag, _native._SOURCES["lanedecode"], defines)))

    def run(lib, case):
        _native._loaded["lanedecode"] = lib
        return lc.lane_decode(*case)

    try:
        # 1024 symbols: one row a group, the launch's fixed cost
        for n, iters in ((LANE_MAIN_N, 50), (LANE_BIG_N, 10), (1024, 100)):
            case, sym, _, _ = lane_decode_case(n, dev)
            plain = lc.lane_decode_plain(*case).cpu().numpy()
            if not np.array_equal(plain, sym):
                raise AssertionError(f"n={n}: plain version differs from the symbols")
            for name, lib in libs:
                got = run(lib, case).cpu().numpy()
                if not np.array_equal(got, sym):
                    raise AssertionError(
                        f"n={n}: {name} differs from the encoded symbols at "
                        f"{int((got != sym).sum())} of {n}")
            passes = [{}, {}]
            for p, order in enumerate((libs, libs[::-1])):
                for name, lib in order:
                    passes[p][name] = graph_ms(lambda: run(lib, case), iters,
                                               args.replays)
            tg = lc.rows_per_group(n)
            floor_ms, formula = lane_decode_floor(tg, case[4].shape[1], sm_mhz)
            print(f"n {n} ({tg} rows a group), all exact; chain floor "
                  f"{floor_ms:.5f} ms = {formula}")
            ref = (passes[0]["kernel"] + passes[1]["kernel"]) / 2
            for name, _ in libs:
                a, b = passes[0][name], passes[1][name]
                mean = (a + b) / 2
                print(f"  {name:<24} {a:.5f} / {b:.5f} ms, mean {mean:.5f} ms "
                      f"({mean / ref:.2f}x kernel, {mean / floor_ms:.2f}x floor)")
    finally:
        _native._loaded["lanedecode"] = libs[0][1]
    return 0


if __name__ == "__main__":
    sys.exit(main())
