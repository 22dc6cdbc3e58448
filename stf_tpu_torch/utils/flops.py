"""FLOP and parameter counts (port of `stf_tpu/utils/flops.py`):

    python -m stf_tpu_torch.utils.flops -a stf --height 256 --width 256

The port's definition of a forward's FLOPs: the eval forward
(`training=False`) of one (1, H, W, 3) image, its matrix products and
convolutions counted as `torch.utils.flop_counter.FlopCounterMode` counts
them: 2 m n k for a linear or a (batched) matmul; 2 x taps x C_in x C_out
x output pixels for a convolution; for a transposed convolution the same
over its *input* pixels (the products it really takes; a stride-s
transposed conv has s^2 times as many output pixels). Biases, norms,
GDN, softmax and the entropy models' elementwise work are not counted.
Kernel B1 (window attention) is counted from its shapes: 2 x 2 x tokens
x window tokens x channels (q k^T and P v). On the card its launch is
invisible to the counter; on the CPU its plain version's two batched
matmuls, which the counter sees at exactly that count, are taken out of
`aten.bmm`, so both devices count the same.

The JAX package counts with XLA's `cost_analysis` of the compiled
forward, which counts other things (PERF.md has the gap by op).
"""

import argparse
import sys
from typing import Dict, Optional, Tuple

import torch


def count_params(model: torch.nn.Module) -> int:
    """Number of parameter elements, as the JAX package counts the leaves
    of `params`: CC_GD's channel masks, flax params there (which the
    optimizer leaves frozen) and buffers here, are counted too."""
    from ..models.cc_gd import GateDecorator

    masks = sum(m.mask.numel() for m in model.modules()
                if isinstance(m, GateDecorator))
    return sum(p.numel() for p in model.parameters()) + masks


def b1_flops(out_shape, window: int) -> int:
    """B1's FLOPs for a (B, H, W, C) output of ws x ws windows: q k^T and
    P v, each 2 x tokens x window tokens x channels."""
    B, H, W, C = out_shape
    return 2 * 2 * B * H * W * window * window * C


def model_flops(model: torch.nn.Module,
                input_shape: Tuple[int, ...] = (1, 256, 256, 3),
                device=None) -> Dict:
    """{"flops", "by_op" ({op: FLOPs}, B1 as "window_attention"),
    "params"} of `model`'s eval forward on zeros of the NHWC
    `input_shape`, on `device` (None: the model's own)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..layers.win_attention import WindowAttention

    if device is not None:
        model = model.to(device)
    device = next(model.parameters()).device
    b1 = []

    def count_b1(mod, args, out):
        b1.append(b1_flops(out.shape, mod.window_size[0]))

    hooks = [m.register_forward_hook(count_b1) for m in model.modules()
             if isinstance(m, WindowAttention)]
    counter = FlopCounterMode(display=False)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), counter:
            model(torch.zeros(input_shape, device=device), training=False)
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    by_op = {str(op).split(".")[-1]: int(n)
             for op, n in counter.get_flop_counts()["Global"].items()}
    if b1:
        if device.type == "cpu":
            # the plain version's two matmuls, seen by the counter
            by_op["bmm"] -= sum(b1)
            if by_op["bmm"] == 0:
                del by_op["bmm"]
        by_op["window_attention"] = sum(b1)
    return {"flops": sum(by_op.values()), "by_op": by_op,
            "params": count_params(model)}


def main(argv: Optional[list] = None) -> Dict:
    from ..models.codec import resolve_device
    from ..zoo import create_model

    p = argparse.ArgumentParser(description="FLOPs/params calculator "
                                "(PyTorch)")
    p.add_argument("-a", "--architecture", default="stf")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "versions of the kernels)")
    args = p.parse_args(argv)

    model = create_model(args.architecture)
    stats = model_flops(model, (1, args.height, args.width, 3),
                        resolve_device(args.device))
    print(f"{args.architecture}: params {stats['params'] / 1e6:.2f}M, "
          f"forward {stats['flops'] / 1e9:.2f} GFLOPs "
          f"({stats['flops']} FLOPs; B1 "
          f"{stats['by_op'].get('window_attention', 0)}) "
          f"@ {args.height}x{args.width} on "
          f"{next(model.parameters()).device}")
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
