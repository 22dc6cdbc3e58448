"""Kernel B4 (layout pin) on the fused decompress's operands: the path its
planner picks, its general path, an earlier build of the kernel, and
PyTorch's copy, each in device time over CUDA-graph replays.

    mkdir -p .smoke_checkout
    git show <rev>:stf_tpu_torch/csrc/layout_pin.cu \
        > .smoke_checkout/layout_pin_before.cu
    python3 tools/compare_layout_pin.py \
        [--before .smoke_checkout/layout_pin_before.cu]

`--before` is a copy of an earlier `layout_pin.cu` with the one-path C
interface `stf_layout_pin(src, dst, n, elem_size, sizes, strides,
stream)`, the first port of B4 (one thread per element, 64-bit index
arithmetic). Each variant is checked bit for bit against
`layout_pin_plain`, then timed by `chip_smoke.graph_ms` in two passes,
the second in reverse order, so that a drift of the card's clocks shows
as a difference between the passes. Needs a CUDA card.
"""

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_before(path):
    """Build the earlier source into stf_tpu_torch/build/ and load it."""
    from stf_tpu_torch import _native

    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, "liblayoutpin_before.so")
    cmd = _native._command("layoutpin", out)
    cmd[-1] = path
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    arr = ctypes.POINTER(ctypes.c_int64)
    lib.stf_layout_pin.restype = ctypes.c_int
    lib.stf_layout_pin.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int, arr, arr,
                                   ctypes.c_void_p]
    return lib


def padded(values, fill):
    return (ctypes.c_int64 * 4)(*((fill,) * (4 - len(values)) + tuple(values)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", help="an earlier layout_pin.cu to time beside")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--replays", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import graph_ms
    from stf_tpu_torch import _native
    from stf_tpu_torch.ans import lane_coder as lc

    if not torch.cuda.is_available():
        print("compare_layout_pin: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda")
    lib = _native.load("layoutpin")
    before = load_before(args.before) if args.before else None

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def general(x):
        """The current kernel's general path on x's merged geometry."""
        size = x.element_size()
        plan = lc.pin_plan(x.shape, x.stride(), size, x.data_ptr())
        out = torch.empty(x.shape, dtype=x.dtype, device=dev)
        rc = lib.stf_layout_pin(
            x.data_ptr(), out.data_ptr(), lc.PIN_KINDS.index("general"), size,
            size, padded(plan.sizes, 1), padded(plan.strides, 0), stream(),
        )
        assert rc == 0, rc
        return out

    def earlier(x):
        out = torch.empty(x.shape, dtype=x.dtype, device=dev)
        rc = before.stf_layout_pin(
            x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(),
            padded(tuple(x.shape), 1), padded(tuple(x.stride()), 0), stream(),
        )
        assert rc == 0, rc
        return out

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    rv = torch.randint(-99, 99, (2, 32, 48, 32), device=dev, generator=g,
                       dtype=torch.int32)
    operands = [  # (what, view, on the fused decompress's path)
        ("mu (2,32,32,48) f32 packed", randn(2, 32, 32, 48), True),
        ("lm (2,320,32,48) f32 packed", randn(2, 320, 32, 48), True),
        ("rv (2,32,32,48) i32 NHWC as NCHW", rv.permute(0, 3, 1, 2), True),
        ("z_hat (2,192,8,12) f32 NHWC as NCHW",
         randn(2, 8, 12, 192).permute(0, 3, 1, 2), True),
        ("lm (2,320,32,48) f32 cropped from (2,320,36,52)",
         randn(2, 320, 36, 52)[:, :, :32, :48], False),
    ]
    for what, x, on_path in operands:
        plan = lc.pin_plan(x.shape, x.stride(), x.element_size(), x.data_ptr())
        torch_copy = x.clone if x.is_contiguous() else x.contiguous
        variants = [(f"kernel ({plan.kind})", lambda: lc.layout_pin(x))]
        if plan.kind != "general":
            variants.append(("general path", lambda: general(x)))
        if before is not None:
            variants.append(("before", lambda: earlier(x)))
        variants.append(
            ("clone()" if x.is_contiguous() else "contiguous()", torch_copy))
        want = lc.layout_pin_plain(x).view(torch.uint8)
        for name, fn in variants:
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.uint8), want):
                raise AssertionError(f"{what}: {name} differs from the plain version")
        passes = [{}, {}]
        for name, fn in variants:
            passes[0][name] = graph_ms(fn, args.iters, args.replays)
        for name, fn in reversed(variants):
            passes[1][name] = graph_ms(fn, args.iters, args.replays)
        ref = variants[-1][0]
        nbytes = 2 * x.numel() * x.element_size()
        print(f"{what}{'' if on_path else ' (not on the main path)'}: "
              f"{nbytes} B moved, bound {nbytes / 3.35e9:.4f} ms")
        for name, _ in variants:
            a, b = passes[0][name], passes[1][name]
            mean = (a + b) / 2
            print(f"  {name:<16} {a:.5f} / {b:.5f} ms, mean {mean:.5f} ms "
                  f"({mean / ((passes[0][ref] + passes[1][ref]) / 2):.2f}x "
                  f"{ref})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
