"""The port's FLOP count (`stf_tpu_torch.utils.flops`) beside the JAX
package's (XLA's `cost_analysis` of the compiled eval forward), by op, on
the CPU:

    JAX_PLATFORMS=cpu python tests/_flops_xla.py [--size 256] [-a cnn stf]

For each model at its registry (full) width it prints the port's count by
op (torch's counter, B1 from its shapes), XLA's total, and XLA's cost of
each convolution the forward runs, lowered alone with the JAX package's
padding (`stf_tpu/layers/conv.py`: a conv padded k//2, a transposed conv
as a stride-dilated input padded (k-1-p, k-1-p+s-1)), beside torch's
count of the same convolution and the count of its products that touch
the image rather than the padding or the dilation's inserted zeros. The
rest of XLA's total (matrix products, attention, elementwise work) is
XLA's total less its convolutions; beside it, B1's count and the count
of the same attention as the JAX package computes it (several windows
packed into one longer attention). Imports JAX, as the tests do; the
port's package never does.
"""

import argparse
import os
import sys
from functools import lru_cache

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def _valid_taps(n_in, n_out, k, stride, pad_lo, dilation):
    """Kernel taps over all outputs, along one axis, that land on an input
    pixel (not padding, not a dilation hole)."""
    count = 0
    for o in range(n_out):
        for t in range(k):
            i = o * stride + t - pad_lo  # index in the dilated, padded input
            if 0 <= i <= (n_in - 1) * dilation and i % dilation == 0:
                count += 1
    return count


@lru_cache(maxsize=None)
def xla_conv_flops(x_shape, k, stride, transposed, c_out):
    """XLA's cost of one NHWC conv of the JAX package's layout."""
    import jax
    import jax.numpy as jnp

    p = k // 2
    if transposed:
        pad = (k - 1 - p, k - 1 - p + stride - 1)
        kw = dict(window_strides=(1, 1), padding=(pad, pad),
                  lhs_dilation=(stride, stride))
    else:
        kw = dict(window_strides=(stride, stride), padding=((p, p), (p, p)))
    w = jax.ShapeDtypeStruct((k, k, x_shape[-1], c_out), jnp.float32)
    x = jax.ShapeDtypeStruct(x_shape, jnp.float32)

    def f(x, w):
        return jax.lax.conv_general_dilated(
            x, w, dimension_numbers=("NHWC", "HWIO", "NHWC"), **kw)

    cost = jax.jit(f).lower(x, w).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"])


def conv_table(model, size):
    """[(kind, x NHWC shape, k, stride, c_out, torch FLOPs, FLOPs on image
    pixels)] of every Conv2d / ConvTranspose2d call of the eval forward
    (GDN's 1x1 convs: a matrix product in both packages, left out)."""
    import torch
    from torch import nn

    rows = []

    def hook(mod, args, out):
        x = args[0]
        B, C, H, W = x.shape
        k, s = mod.kernel_size[0], mod.stride[0]
        taps_full = k * k
        if isinstance(mod, nn.ConvTranspose2d):
            torch_f = 2 * B * H * W * taps_full * C * mod.out_channels
            Ho, Wo = out.shape[2:]
            p = k // 2
            lo = k - 1 - p
            valid = (_valid_taps(H, Ho, k, 1, lo, s)
                     * _valid_taps(W, Wo, k, 1, lo, s))
            kind = "transposed"
        else:
            Ho, Wo = out.shape[2:]
            torch_f = 2 * B * Ho * Wo * taps_full * C * mod.out_channels
            p = mod.padding[0]
            valid = (_valid_taps(H, Ho, k, s, p, 1)
                     * _valid_taps(W, Wo, k, s, p, 1))
            kind = "conv"
        rows.append((kind, (B, H, W, C), k, s, mod.out_channels, torch_f,
                     2 * B * valid * C * mod.out_channels))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    with torch.no_grad():
        model.eval()(torch.zeros(1, size, size, 3), training=False)
    for h in hooks:
        h.remove()
    return rows


def attention_table(model, size):
    """(B1's FLOPs, the same calls' FLOPs as the JAX package computes them
    at eval: G windows packed into one <= 128-token attention, each
    product G times as long, `stf_tpu/layers/win_attention.py`'s
    `_pack_group`) over the eval forward's window attentions."""
    import torch

    from stf_tpu.layers.win_attention import _pack_group
    from stf_tpu_torch.layers.win_attention import WindowAttention
    from stf_tpu_torch.utils.flops import b1_flops

    b1 = [0, 0]

    def hook(mod, args, out):
        B, H, W, C = out.shape
        ws = mod.window_size[0]
        f = b1_flops(out.shape, ws)
        b1[0] += f
        b1[1] += f * _pack_group((H // ws) * (W // ws), ws * ws)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, WindowAttention)]
    with torch.no_grad():
        model.eval()(torch.zeros(1, size, size, 3), training=False)
    for h in hooks:
        h.remove()
    return tuple(b1)


def xla_total(name, size):
    """XLA's cost_analysis FLOPs of the JAX registry model's eval forward
    (params from `jax.eval_shape`, so flax's init never runs)."""
    import jax
    import jax.numpy as jnp

    from stf_tpu.zoo import models

    model = models[name]()
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    params = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.zeros((1, size, size, 3)), training=False))["params"]
    fn = jax.jit(lambda p, xx: model.apply({"params": p}, xx,
                                           training=False))
    cost = fn.lower(params, x).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"])


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from stf_tpu_torch.utils.flops import model_flops
    from stf_tpu_torch.zoo import create_model

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-a", "--architectures", nargs="*",
                   default=["cnn", "stf", "tbc", "cc", "cc_gd", "dystf"])
    p.add_argument("--size", type=int, default=256)
    args = p.parse_args(argv)
    for name in args.architectures:
        model = create_model(name, seed=0)
        port = model_flops(model, (1, args.size, args.size, 3), "cpu")
        rows = conv_table(model, args.size)
        torch_conv = sum(r[5] for r in rows)
        image_conv = sum(r[6] for r in rows)
        xla_conv = sum(xla_conv_flops(r[1], r[2], r[3], r[0] == "transposed",
                                      r[4]) for r in rows)
        by_kind = {}
        for kind, *_, t, v in rows:
            a = by_kind.setdefault(kind, [0, 0])
            a[0] += t
            a[1] += v
        total = xla_total(name, args.size)
        print(f"{name} @ {args.size}x{args.size}: port {port['flops']} "
              f"by op {port['by_op']}; XLA total {total:.0f} "
              f"(port / XLA {port['flops'] / total:.4f})")
        print(f"  Conv2d / ConvTranspose2d modules: torch counts "
              f"{torch_conv}, on image pixels {image_conv}, XLA alone "
              f"{xla_conv:.0f}; by kind (torch, on image pixels): {by_kind}")
        b1, packed = attention_table(model, args.size)
        rest = port["flops"] - torch_conv
        print(f"  the rest: port {rest}, XLA {total - xla_conv:.0f}; of the "
              f"port's, B1 {b1}, which the JAX package's packed windows "
              f"compute as {packed}; XLA less the port's rest with B1 "
              f"packed: {total - xla_conv - (rest - b1 + packed):.0f} "
              "(XLA's elementwise work, which torch does not count)")


if __name__ == "__main__":
    main()
