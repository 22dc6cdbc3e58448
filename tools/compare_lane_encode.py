"""Kernel B3 (lane-rANS encode) against an earlier build of itself and
against builds of its own source with other compile-time settings, each
in device time over CUDA-graph replays, at the main path's slice
(98,304 symbols), at 1,179,648 symbols and at 1024 (one row a group: the
launch's fixed cost).

    mkdir -p .smoke_checkout
    git show <rev>:stf_tpu_torch/csrc/lane_encode.cu \\
        > .smoke_checkout/lane_encode_before.cu
    python3 tools/compare_lane_encode.py \\
        [--before .smoke_checkout/lane_encode_before.cu] \\
        [--variant CHUNK=8,UNROLL=4 ...] [--stamps]

`--before` is a copy of an earlier `lane_encode.cu` with the same C
interface (`stf_lane_encode_device`). Each `--variant` builds the current
source with `LANE_ENCODE_<NAME>` set to each value (CHUNK, UNROLL: the
kernel's compile-time settings). `--stamps` adds a build with
LANE_ENCODE_STAMPS=1 and prints where a block's SM cycles go: the
prologue, pass A (escapes) and pass B (the rANS chain), means over the 8
groups as warp 0 reads its clock. Every build's four outputs are checked
against `lane_encode_device_plain` on the same inputs (the stamped
build's counts columns 3-5 excepted), then each build is timed by
`chip_smoke.graph_ms` in two passes, the second in reverse order, so
that a drift of the card's clocks shows as a difference between the
passes. Prints each build's registers and spills as ptxas reports them.
Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", help="an earlier lane_encode.cu to time beside")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: LANE_ENCODE_<NAME> settings")
    ap.add_argument("--stamps", action="store_true",
                    help="add a build that reports its phases' SM cycles")
    ap.add_argument("--replays", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import (LANE_BIG_N, LANE_MAIN_N, graph_ms, lane_encode_floor,
                            lane_inputs, ptxas_summary, sm_clock_mhz)
    from compare_lane_decode import build
    from stf_tpu_torch import _native
    from stf_tpu_torch.ans import lane_coder as lc

    if not torch.cuda.is_available():
        print("compare_lane_encode: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sm_mhz = sm_clock_mhz()
    print(f"card: {smi}, max SM clock {sm_mhz:g} MHz")
    dev = torch.device("cuda")
    _native.build_all(["laneencode"], force=True)
    libs = [("kernel", _native.load("laneencode"))]
    logs = {"kernel": _native.build_logs["laneencode"]}
    if args.before:
        libs.append(("before", build("before", args.before, name="laneencode")))
        logs["before"] = _native.build_logs["laneencode_before"]
    if args.stamps:
        args.variant.append("STAMPS=1")
    for spec in args.variant:
        defines = [f"LANE_ENCODE_{d}" for d in spec.split(",")]
        tag = spec.replace("=", "").replace(",", "_").lower()
        libs.append((spec, build(tag, _native._SOURCES["laneencode"], defines,
                                 name="laneencode")))
        logs[spec] = _native.build_logs[f"laneencode_{tag}"]
    for name, log in logs.items():
        for line in ptxas_summary(log):
            print(f"ptxas {name}: {line}")

    def run(lib, case):
        _native._loaded["laneencode"] = lib
        return lc.lane_encode_device(*case)

    try:
        # 1024 symbols: one row a group, the launch's fixed cost
        for n, iters in ((LANE_MAIN_N, 50), (LANE_BIG_N, 10), (1024, 100)):
            tables, sym, idx = lane_inputs(n)
            case = (
                torch.from_numpy(sym).to(dev), torch.from_numpy(idx).to(dev),
                *lc.table_tensors(tables, dev), n, int(tables.offsets[0]),
            )
            plain = lc.lane_encode_device_plain(*case)
            stamps = []
            for name, lib in libs:
                got = list(run(lib, case))
                if name == "STAMPS=1":
                    stamps = got[3][:, 3:6].double().mean(0).tolist()
                    got[3] = torch.cat([got[3][:, :3], plain[3][:, 3:6],
                                        got[3][:, 6:]], 1)
                for field, a, b in zip(("words", "side", "states", "counts"),
                                       got, plain):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"n={n}: {name}'s {field} differ from the plain "
                            f"version's at {int((a != b).sum())} cells")
            passes = [{}, {}]
            for p, order in enumerate((libs, libs[::-1])):
                for name, lib in order:
                    passes[p][name] = graph_ms(lambda: run(lib, case), iters,
                                               args.replays)
            tg = lc.encode_caps(n)[0]
            floor_ms, formula = lane_encode_floor(tg, sm_mhz)
            print(f"n {n} ({tg} rows a group), all equal to the plain version; "
                  f"chain floor {floor_ms:.5f} ms = {formula}")
            if stamps:
                print("  SM cycles a block (STAMPS=1): prologue {:.0f}, pass A "
                      "{:.0f}, pass B {:.0f}".format(*stamps))
            ref = (passes[0]["kernel"] + passes[1]["kernel"]) / 2
            for name, _ in libs:
                a, b = passes[0][name], passes[1][name]
                mean = (a + b) / 2
                print(f"  {name:<24} {a:.5f} / {b:.5f} ms, mean {mean:.5f} ms "
                      f"({mean / ref:.2f}x kernel, {mean / floor_ms:.2f}x floor)")
    finally:
        _native._loaded["laneencode"] = libs[0][1]
    return 0


if __name__ == "__main__":
    sys.exit(main())
