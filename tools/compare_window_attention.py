"""Kernel B1's head-group design against its window-head design, and
against builds of its own source with other compile-time settings, at
TBC's four 8x8 stage shapes (batch 2 at a 512x768 input, 32 heads of
widths 4, 6, 8 and 10, shifted), f32 and bf16, in device time over
CUDA-graph replays.

    python3 tools/compare_window_attention.py [--variant GROUP=2 ...]
        [--variant EXP2=0] [--stages 0,1,2,3]

Each `--variant` builds `csrc/window_attention.cu` with
`WINATTN_HG_<NAME>` set to each value (GROUP: heads a block; STAMPS: 1
for a build that sums block 0's clock64() by phase, printed per window
after the times); a variant of the source itself can be tried the same
way from a copy with its own macro. Every build is checked first:
within `chip_smoke.ATTN_TOL` of the plain version in f32 and one bf16 ulp
in bf16, two launches bit-equal, and in f32 with the bias x30 no farther
from an f64 plain version than the f32 plain version. Then each is timed
in two passes, the second in reverse order (window-head first and last),
beside the byte bound and the softmax floor (`chip_smoke.softmax_floor`).
Prints nvcc's registers and spills for every head-group instance. Needs a
CUDA card.
"""

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (feature map, channels) of TBC's four stages; 8x8 windows, 32 heads
STAGES = (((256, 384), 128), ((128, 192), 192), ((64, 96), 256),
          ((32, 48), 320))


def build(variants):
    """{spec: library} of the current source built once per `--variant`
    spec with its `-D` defines, all nvcc processes at once, into
    stf_tpu_torch/build/, each loaded with B1's declarations; nvcc's output
    goes to `_native.build_logs[f"winattn_{spec}"]`."""
    from stf_tpu_torch import _native

    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    jobs = []
    for spec in variants:
        tag = spec.replace("=", "").replace(",", "_").lower()
        out = os.path.join(_native.BUILD_DIR, f"libwinattn_{tag}.so")
        cmd = _native._command("winattn", out)
        cmd[-1:] = [f"-DWINATTN_HG_{d}" for d in spec.split(",")] + [
            _native._SOURCES["winattn"]]
        jobs.append((spec, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for spec, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{spec}: build failed\n{log}")
        _native.build_logs[f"winattn_{spec}"] = log
        libs[spec] = ctypes.CDLL(out)
        _native._declarations["winattn"](libs[spec])
    return libs


def inputs(dev, gen, hw, C, dtype, bias_scale=1.0):
    import torch

    from stf_tpu_torch.layers import shifted_window_region_labels

    (h, w), nh = hw, 32
    qkv = torch.randn(2, h, w, 3 * C, device=dev, generator=gen)
    bias = torch.randn(nh, 64, 64, device=dev, generator=gen) * bias_scale
    labels = torch.from_numpy(shifted_window_region_labels(h, w, 8, 4)).to(dev)
    return qkv.to(dtype), bias.to(dtype), labels


def dump_sass(library, path):
    """The head-group kernels' SASS from `library` (cuobjdump -sass) into
    `path`; prints each kernel's instruction count and its commonest
    opcodes."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    kept, name, ops = [], None, collections.Counter()

    def flush():
        if name is not None:
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common(14))
            print(f"sass {name}: {sum(ops.values())} instructions; {top}")

    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            name = m.group(1) if "head_group" in m.group(1) else None
            ops = collections.Counter()
        if name is None:
            continue
        kept.append(line)
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m:
            ops[m.group(1)] += 1
    flush()
    with open(path, "w") as f:
        f.write("\n".join(kept))


PHASES = ("wait", "stage", "vote", "S", "pass 1", "pass 2", "P.v", "store")


def phase_cycles(launch, stamps, hd, bf16, windows, nh):
    """Block 0's SM cycles a window by phase from one launch of a
    WINATTN_HG_STAMPS=1 build: warp 0's, and the slowest warp's."""
    import torch

    from stf_tpu_torch.layers import attention_core as ac

    stamps.restype = ctypes.c_int
    stamps.argtypes = [ctypes.c_void_p]
    host = (ctypes.c_ulonglong * (32 * 8))()
    launch()
    torch.cuda.synchronize()
    stamps(host)  # zero
    launch()
    torch.cuda.synchronize()
    if stamps(host):
        raise RuntimeError("reading the stamps failed")
    group, blocks, sms = ac._head_group_shape(0, hd, bf16)
    _, chunks = ac.head_group_plan(windows, nh, group, sms, blocks)
    n = len(ac.head_group_walk(0, chunks, windows))
    per = [[host[w * 8 + k] / n for k in range(8)] for w in range(4 * group)]
    slow = max(per, key=sum)
    return (f"cycles a window ({'/'.join(PHASES)}): warp 0 "
            f"{'/'.join(f'{c:.0f}' for c in per[0])}, slowest warp "
            f"{'/'.join(f'{c:.0f}' for c in slow)}, total {sum(per[0]):.0f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: WINATTN_HG_<NAME> settings")
    ap.add_argument("--stages", default="0,1,2,3")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sass", help="write the head-group kernels' SASS (the "
                    "main build's, cuobjdump) to this file and print each "
                    "kernel's instruction count")
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import (ATTN_TOL, BF16_OPS_PER_S, bf16_ulp_errors, bound,
                            graph_ms, ptxas_summary, sm_clock_mhz,
                            softmax_floor)
    from stf_tpu_torch import _native
    from stf_tpu_torch.layers import attention_core as ac

    if not torch.cuda.is_available():
        print("compare_window_attention: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sm_mhz = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {smi}, max SM clock {sm_mhz:g} MHz, {sms} SMs")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    main_lib = _native.load("winattn")
    libs = [("kernel", main_lib)] + list(build(args.variant).items())
    for name, _ in libs:
        log = _native.build_logs["winattn" if name == "kernel"
                                 else f"winattn_{name}"]
        for line in ptxas_summary(log):
            if "head_group" in line:
                print(f"ptxas {name}: {line}")

    if args.sass:
        dump_sass(_native.library_path("winattn"), args.sass)

    def run(lib, design, qkv, bias, labels, scale):
        # a library's plan is read again only when the library changes (the
        # warm-up calls before a graph capture), never inside a capture
        if _native._loaded["winattn"] is not lib:
            _native._loaded["winattn"] = lib
            ac._head_group_shape.cache_clear()
        return ac._launch(qkv, bias, labels, 8, scale, design)

    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        for stage in (int(s) for s in args.stages.split(",")):
            hw, C = STAGES[stage]
            hd, nh = C // 32, 32
            scale = hd ** -0.5
            for dtype in (torch.float32, torch.bfloat16):
                bf16 = dtype == torch.bfloat16
                old = "bf16_mma" if bf16 else "window_head"
                qkv, bias, labels = inputs(dev, gen, hw, C, dtype)
                plain = ac.window_attention_plain(qkv, bias, labels, 8, scale)
                cases = [(f"window_head ({old})", main_lib, old)] + [
                    (f"head_group {name}", lib, ac.HEAD_GROUP)
                    for name, lib in libs]
                notes = {}
                for label, lib, design in cases:
                    out = run(lib, design, qkv, bias, labels, scale)
                    again = run(lib, design, qkv, bias, labels, scale)
                    torch.cuda.synchronize()
                    if not torch.equal(out, again):
                        raise AssertionError(f"stage {stage} {dtype} {label}: "
                                             "two launches differ")
                    if bf16:
                        err = bf16_ulp_errors(out, plain).max().item()
                        ok, unit = err <= 1.0, "bf16 ulps"
                    else:
                        err = (out - plain).abs().max().item()
                        ok, unit = err <= ATTN_TOL, "max abs"
                    if not ok:
                        raise AssertionError(f"stage {stage} {dtype} {label}: "
                                             f"{err:.3g} {unit} from plain")
                    notes[label] = f"{err:.3g} {unit}"
                if not bf16:
                    q30, b30, l30 = inputs(dev, gen, hw, C, dtype, 30.0)
                    exact = ac.window_attention_plain(q30.double(), b30.double(),
                                                      l30, 8, scale)
                    p_err = (ac.window_attention_plain(q30, b30, l30, 8, scale)
                             .double() - exact).abs().max().item()
                    for label, lib, design in cases:
                        e = (run(lib, design, q30, b30, l30, scale).double()
                             - exact).abs().max().item()
                        if not e <= min(ATTN_TOL, p_err):
                            raise AssertionError(
                                f"stage {stage} {label} bias x30: {e:.3g} from "
                                f"f64, f32 plain {p_err:.3g}")
                        notes[label] += f", bias x30 {e:.3g} from f64"
                    notes["plain"] = f"bias x30 {p_err:.3g} from f64"
                passes = [{}, {}]
                for p, order in enumerate((cases, cases[::-1])):
                    for label, lib, design in order:
                        passes[p][label] = graph_ms(
                            lambda: run(lib, design, qkv, bias, labels, scale),
                            args.iters)
                esize = 2 if bf16 else 4
                nbytes = (qkv.numel() + plain.numel() + bias.numel()) * esize \
                    + labels.numel() * 4
                windows = 2 * labels.shape[0]
                ops = 4 * 64 * 64 * hd * windows * nh
                bound_ms, by = bound(nbytes, ops,
                                     BF16_OPS_PER_S if bf16 else 67e12)
                floor_ms = softmax_floor(windows * nh, 64, sm_mhz, sms)
                print(f"stage {stage} {str(dtype)[6:]} qkv {tuple(qkv.shape)} "
                      f"hd {hd}: bound {bound_ms:.4f} ms ({by}), softmax floor "
                      f"{floor_ms:.4f} ms; plain {notes.get('plain', '')}")
                ref = (passes[0][cases[0][0]] + passes[1][cases[0][0]]) / 2
                for label, lib, design in cases:
                    stamps = getattr(lib, "stf_window_attention_head_group_stamps",
                                     None) if design == ac.HEAD_GROUP else None
                    if stamps is not None:
                        notes[label] += "; " + phase_cycles(
                            lambda: run(lib, design, qkv, bias, labels, scale),
                            stamps, hd, bf16, labels.shape[0] * 2, nh)
                for label, _, _ in cases:
                    a, b = passes[0][label], passes[1][label]
                    mean = (a + b) / 2
                    print(f"  {label:<28} {a:.4f} / {b:.4f} ms, mean {mean:.4f}"
                          f" ({ref / mean:.2f}x window_head, "
                          f"{100 * bound_ms / mean:.1f}% of bound); "
                          f"{notes[label]}")
    finally:
        _native._loaded["winattn"] = main_lib
        ac._head_group_shape.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
