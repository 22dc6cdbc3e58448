"""Shared codec model machinery (port of `stf_tpu/models/base.py`).

`ChannelARModel` is the channel-wise autoregressive protocol of the
reference family (`compressai/models/cnn.py:141-332`): hyper-latent z via
h_a, z_hat rounded around the medians, hyper synthesis into per-latent
means/scales, and a slice loop where slice i conditions on up to
`max_support_slices` decoded slices, with a latent-response-prediction
correction. `forward(x, training=True, sampler=...)` is the training
forward of `stf_tpu/models/base.py:125-174`: noisy likelihoods,
straight-through rounding; its random draws come from `sampler` in the
JAX package's order (the analysis's DropPath masks, z's noise, each
slice's noise, the synthesis's masks).

Layouts: `forward` takes and returns NHWC like the JAX model; the
coding-path methods the Codec drives (`analyze`, `hyper_synthesize`,
`decode_slice_*`, `synthesize`) work on NCHW tensors, the transforms'
internal layout.
"""

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..entropy import gaussian_build_indexes, gaussian_forward
from ..layers.conv import conv, conv3x3, subpel_conv3x3
from ..ops import ste_round

_ACTIVATIONS = {"gelu": nn.GELU, "relu": nn.ReLU}


def conv_gelu_stack(channels: Sequence[int], strides: Sequence[int],
                    kernel_sizes: Optional[Sequence[int]] = None,
                    activation: str = "gelu"):
    """Conv stack (3x3 unless `kernel_sizes` says otherwise, padding k//2)
    with a GELU or ReLU between layers (none after the last); convs sit at
    even Sequential indices like the reference's (`ConvGeluStack` of the
    JAX package)."""
    kernel_sizes = kernel_sizes or (3,) * len(strides)
    layers = []
    for i, (k, s) in enumerate(zip(kernel_sizes, strides)):
        layers.append(conv(channels[i], channels[i + 1], k, stride=s))
        if i < len(strides) - 1:
            layers.append(_ACTIVATIONS[activation]())
    return nn.Sequential(*layers)


def hyper_synthesis(c: Sequence[int]):
    """h_mean_s / h_scale_s: 4x upsampling through the six widths c: conv,
    subpel 2x, conv, subpel 2x, conv (keys .0, .2.0, .4, .6.0, .8)."""
    return nn.Sequential(
        conv3x3(c[0], c[1]), nn.GELU(),
        subpel_conv3x3(c[1], c[2], 2), nn.GELU(),
        conv3x3(c[2], c[3]), nn.GELU(),
        subpel_conv3x3(c[3], c[4], 2), nn.GELU(),
        conv3x3(c[4], c[5]),
    )


def slice_transform(in_ch: int, out_ch: int):
    """5-stage 3x3 stack in -> 224 -> 176 -> 128 -> 64 -> out (reference
    `cnn.py:89-127`)."""
    return conv_gelu_stack((in_ch, 224, 176, 128, 64, out_ch), (1,) * 5)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter from `generator`: convs and linears
    uniform in ±1/sqrt(fan_in) (torch's default scale), relative-position
    tables N(0, 0.02) clipped at ±0.04, LayerNorms to weight 1 and bias 0,
    GDN and the bottleneck by their own `reset_parameters`. Deterministic
    for a given generator state."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()  # draws nothing
            elif hasattr(m, "relative_position_bias_table"):
                t = m.relative_position_bias_table
                t.normal_(0.0, 0.02, generator=generator).clamp_(-0.04, 0.04)
            elif hasattr(m, "reset_parameters") and not list(m.children()):
                m.reset_parameters(generator)
    return model


class ChannelARModel(nn.Module):
    """Base for codecs with a channel-AR Gaussian conditional over slices.

    Subclasses set g_a, g_s, h_a, h_mean_s, h_scale_s,
    cc_mean_transforms / cc_scale_transforms / lrp_transforms,
    entropy_bottleneck, num_slices and max_support_slices."""

    hyper_upsample = 4
    analysis_downsample = 16  # y is ceil(H/16) x ceil(W/16) of the image

    def analysis(self, x, sampler=None):
        return self.g_a(x)

    def synthesis(self, y_hat, sampler=None):
        return self.g_s(y_hat)

    # -- slice helpers --------------------------------------------------------

    def _support(self, y_hat_slices):
        k = self.max_support_slices
        return list(y_hat_slices) if k < 0 else list(y_hat_slices)[:k]

    def slice_boundaries(self, M: int):
        """Channel split points: ceil(M/S)-wide slices, remainder last."""
        w = -(-M // self.num_slices)
        return [min(w * i, M) for i in range(1, self.num_slices)]

    def split_slices(self, y):
        bounds = [0] + self.slice_boundaries(y.shape[1]) + [y.shape[1]]
        return [y[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def _slice_mu_scale(self, i, latent_means, latent_scales, support_slices):
        mean_support = torch.cat([latent_means] + list(support_slices), dim=1)
        mu = self.cc_mean_transforms[i](mean_support)
        scale_support = torch.cat([latent_scales] + list(support_slices), dim=1)
        scale = self.cc_scale_transforms[i](scale_support)
        return mu, scale, mean_support

    def _lrp(self, i, mean_support, y_hat_slice):
        lrp_support = torch.cat([mean_support, y_hat_slice], dim=1)
        return 0.5 * torch.tanh(self.lrp_transforms[i](lrp_support))

    # -- forward ----------------------------------------------------------------

    def forward(self, x, training: bool = False, sampler=None) -> Dict:
        """x: NHWC float in [0, 1]. Returns the unclipped NHWC x_hat and NHWC
        likelihoods {"y", "z"}: rounding quantization, or in training
        noise drawn from `sampler` and straight-through rounding."""
        if training and sampler is None:
            raise ValueError("the training forward draws its noise from a "
                             "sampler; none was given")
        y = self.analysis(x.permute(0, 3, 1, 2).contiguous(), sampler)
        y_hat, likelihoods = self.entropy_forward(y, training, sampler)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return {
            "x_hat": nhwc(self.synthesis(y_hat, sampler)),
            "likelihoods": {k: nhwc(v) for k, v in likelihoods.items()},
        }

    def entropy_forward(self, y, training: bool = False, sampler=None):
        """Hyper path + channel-AR slice loop on NCHW y; returns (y_hat,
        likelihoods)."""
        z = self.h_a(y)
        _, z_likelihoods = self.entropy_bottleneck(z, training, sampler)
        medians = self.entropy_bottleneck.medians()[None, :, None, None]
        rnd = ste_round if training else torch.round
        z_hat = rnd(z - medians) + medians
        latent_means, latent_scales = self.hyper_synthesize(
            z_hat, (y.shape[2], y.shape[3])
        )
        y_hat_slices, y_likelihoods = [], []
        for i, y_slice in enumerate(self.split_slices(y)):
            mu, scale, mean_support = self._slice_mu_scale(
                i, latent_means, latent_scales, self._support(y_hat_slices)
            )
            y_hat_slice = rnd(y_slice - mu) + mu
            _, lik = gaussian_forward(y_slice, scale, mu, training, sampler)
            y_likelihoods.append(lik)
            y_hat_slice = y_hat_slice + self._lrp(i, mean_support, y_hat_slice)
            y_hat_slices.append(y_hat_slice)
        likelihoods = {"y": torch.cat(y_likelihoods, dim=1), "z": z_likelihoods}
        return torch.cat(y_hat_slices, dim=1), likelihoods

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()

    # -- coding-path methods (NCHW), driven by models/codec.py ----------------

    def analyze(self, x):
        """Encoder-side transforms: x -> (y, z)."""
        y = self.analysis(x)
        return y, self.h_a(y)

    def hyper_synthesize(self, z_hat, y_shape):
        h, w = y_shape
        latent_scales = self.h_scale_s(z_hat)[:, :, :h, :w]
        latent_means = self.h_mean_s(z_hat)[:, :, :h, :w]
        return latent_means, latent_scales

    def decode_slice_indexes(self, i, latent_means, latent_scales, support,
                             scale_table):
        """First decode half-step: per-slice mu + scale-table indexes."""
        mu, scale, _ = self._slice_mu_scale(
            i, latent_means, latent_scales, support
        )
        return mu, gaussian_build_indexes(scale, scale_table)

    def decode_slice_apply(self, i, latent_means, support, mu, rv):
        """Second half-step: dequantize + lrp correction -> y_hat slice."""
        mean_support = torch.cat([latent_means] + list(support), dim=1)
        y_hat_slice = rv.to(mu.dtype) + mu
        return y_hat_slice + self._lrp(i, mean_support, y_hat_slice)

    def decode_slice_fused(self, i, latent_means, latent_scales, support,
                           mu_prev, rv_prev, scale_table):
        """Reconstruct slice i-1 from its symbols, then compute slice i's
        (mu, indexes). `support` is slice i-1's capped support list."""
        support = list(support)
        y_hat_prev = self.decode_slice_apply(
            i - 1, latent_means, support, mu_prev, rv_prev
        )
        support_i = self._support(support + [y_hat_prev])
        mu, idx = self.decode_slice_indexes(
            i, latent_means, latent_scales, support_i, scale_table
        )
        return y_hat_prev, mu, idx

    def synthesize(self, y_hat):
        return torch.clamp(self.synthesis(y_hat), 0.0, 1.0)


def slice_widths(M: int, num_slices: int):
    """Each slice's channels: ceil(M / num_slices), the remainder on the
    last (`ChannelARModel.slice_boundaries`)."""
    w = -(-M // num_slices)
    return [min(w * (i + 1), M) - min(w * i, M) for i in range(num_slices)]


def slice_supports(M: int, num_slices: int, max_support: int):
    """(each slice's width, the channels of its decoded support): slice i
    conditions on the first min(i, max_support) slices (all i when
    max_support < 0), at their own widths."""
    widths = slice_widths(M, num_slices)
    return widths, [sum(widths[:i if max_support < 0 else min(i, max_support)])
                    for i in range(num_slices)]


def make_slice_transforms(M: int, num_slices: int, max_support: int,
                          hyper_ch: Optional[int] = None,
                          stack=slice_transform):
    """(cc_mean, cc_scale, lrp) ModuleLists of `stack(in, out)` with the
    reference widths: slice i (`slice_supports`) sees the `hyper_ch` (M by
    default) channels of the hyper synthesis plus its decoded support;
    lrp also sees the slice itself."""
    widths, support = slice_supports(M, num_slices, max_support)
    ctx = [(hyper_ch or M) + s for s in support]
    return (
        nn.ModuleList(stack(c, w) for c, w in zip(ctx, widths)),
        nn.ModuleList(stack(c, w) for c, w in zip(ctx, widths)),
        nn.ModuleList(stack(c + w, w) for c, w in zip(ctx, widths)),
    )
