"""CC_GD, the CC codec with Gate-Decorator channel pruning (port of
`stf_tpu/models/cc_gd.py`, eval forward and codec paths).

A `GateDecorator` after a conv multiplies its output by a per-channel
`gate` and a binary `mask`, both (1, C, 1, 1) as the reference stores
them (`CC_gd.py:735-756`). Gates follow every conv of h_a, h_mean_s and
h_scale_s and the first two convs of every slice stack; g_a and g_s are
CC's, ungated. The stacks keep the reference's Sequential layout, conv at
3i, gate at 3i + 1, ReLU at 3i + 2 (`CC_gd.py:27-135`), so state_dict
keys are the reference torch keys. `gate` is a parameter; `mask` a
buffer, which no optimizer updates (the JAX package keeps it a parameter
that its train state freezes). The Taylor scores of the pruning loop are
training state and are not part of the eval model.

`CC_GD(deps=...)` is the ungated build at pruned widths, the shape a
physically pruned export reloads into (`CC_GD(deps=...)` of the JAX
package): `deps` holds ("<stack>/gate_<i>", kept channels) pairs, each
gate position is an `nn.Identity` (so the convs keep their keys), and z
is `h_a/gate_2`'s width. Training with gates, the pruning loop and the
pruned export come with `train_gd` (ROADMAP A.8).
"""

from typing import Dict

import torch
import torch.nn as nn

from ..entropy import EntropyBottleneck
from ..layers import conv, deconv
from .base import ChannelARModel, slice_supports
from .cc import cc_analysis, cc_synthesis, hyper_mid


class GateDecorator(nn.Module):
    """x * gate * mask over the channels of an NCHW map
    (`CC_gd.py:735-756`); both start at ones."""

    def __init__(self, channels: int):
        super().__init__()
        self.gate = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.register_buffer("mask", torch.ones(1, channels, 1, 1))

    def forward(self, x):
        return x * self.gate * self.mask

    def reset_parameters(self, generator=None):
        """Gates and masks back to ones (`init_weights` calls this)."""
        with torch.no_grad():
            self.gate.fill_(1.0)
            self.mask.fill_(1.0)


def gated_stack(channels, kernel_sizes, strides, deconvs=(), gate_last=True,
                gated=True):
    """conv -> gate -> ReLU chain over the widths `channels` (in, then one a
    layer): conv (or transposed conv where `deconvs` says so) at Sequential
    index 3i, its GateDecorator at 3i + 1 (an Identity when not `gated`,
    none after the last conv unless `gate_last`), ReLU at 3i + 2."""
    n = len(strides)
    layers = []
    for i, (k, s) in enumerate(zip(kernel_sizes, strides)):
        make = deconv if i < len(deconvs) and deconvs[i] else conv
        layers.append(make(channels[i], channels[i + 1], k, stride=s))
        if i < n - 1 or gate_last:
            layers.append(GateDecorator(channels[i + 1]) if gated
                          else nn.Identity())
        if i < n - 1:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class CC_GD(ChannelARModel):
    """Gate-decorated CC ("cc_gd" in the registry); `deps` builds the
    ungated model at pruned widths (module docstring)."""

    def __init__(self, N: int = 192, M: int = 320, num_slices: int = 10,
                 max_support_slices: int = 5, sparse_lambda: float = 0.5,
                 deps=()):
        super().__init__()
        deps = dict(deps)
        gated = not deps

        def w(key, default):
            return deps.get(key, default)

        self.M, self.N = M, w("h_a/gate_2", N)
        self.num_slices = num_slices
        self.max_support_slices = max_support_slices
        self.sparse_lambda = sparse_lambda
        mid = hyper_mid(N, M)
        self.g_a = cc_analysis(N, M)
        self.g_s = cc_synthesis(N, M)
        self.h_a = gated_stack(
            (M, w("h_a/gate_0", M), w("h_a/gate_1", mid), self.N), (3, 5, 5),
            (1, 2, 2), gated=gated,
        )
        hyper_out = {}
        for name in ("h_mean_s", "h_scale_s"):
            hyper_out[name] = w(f"{name}/gate_2", M)
            setattr(self, name, gated_stack(
                (self.N, w(f"{name}/gate_0", N), w(f"{name}/gate_1", mid),
                 hyper_out[name]), (5, 5, 3), (2, 2, 1),
                deconvs=(True, True, False), gated=gated,
            ))
        widths, support = slice_supports(M, num_slices, max_support_slices)

        def slice_stack(prefix, i, in_ch):
            return gated_stack(
                (in_ch, w(f"{prefix}_{i}/gate_0", 224),
                 w(f"{prefix}_{i}/gate_1", 128), widths[i]),
                (3, 3, 3), (1, 1, 1), gate_last=False, gated=gated,
            )

        mean_ch, scale_ch = hyper_out["h_mean_s"], hyper_out["h_scale_s"]
        self.cc_mean_transforms = nn.ModuleList(
            slice_stack("cc_mean", i, mean_ch + s)
            for i, s in enumerate(support))
        self.cc_scale_transforms = nn.ModuleList(
            slice_stack("cc_scale", i, scale_ch + s)
            for i, s in enumerate(support))
        self.lrp_transforms = nn.ModuleList(
            slice_stack("lrp", i, mean_ch + s + widths[i])
            for i, s in enumerate(support))
        self.entropy_bottleneck = EntropyBottleneck(self.N)


def _cc_gd_key(key: str) -> str:
    """A CC state_dict key -> the CC_GD key of the same tensor: h_a's conv
    2i and the slice stacks' conv 2j move to 3i and 3j, the hyper
    synthesis stacks' .0 / .2 / .4 to .0 / .3 / .6; g_a, g_s and the
    bottleneck keep theirs."""
    parts = key.split(".")
    if parts[0] in ("h_a", "h_mean_s", "h_scale_s"):
        parts[1] = str(3 * (int(parts[1]) // 2))
    elif parts[0] in ("cc_mean_transforms", "cc_scale_transforms",
                      "lrp_transforms"):
        parts[2] = str(3 * (int(parts[2]) // 2))
    return ".".join(parts)


def init_cc_gd_from_cc(cc_state: Dict[str, torch.Tensor],
                       cc_gd_state: Dict[str, torch.Tensor]):
    """A CC_GD state_dict holding a CC's weights (`init_cc_gd_from_cc` of
    the JAX package, the reference's KEY_TABLE flow, `CC_gd.py:357-556`):
    every CC tensor at its CC_GD key, gates and masks at ones, so the
    gated model computes what the CC did. Raises KeyError for a CC key
    with no CC_GD counterpart."""
    out = {k: torch.ones_like(v) if k.endswith((".gate", ".mask")) else v
           for k, v in cc_gd_state.items()}
    for key, value in cc_state.items():
        target = _cc_gd_key(key)
        if target not in out or out[target].shape != value.shape:
            raise KeyError(f"CC key {key!r} has no CC_GD counterpart")
        out[target] = value.clone()
    return out
