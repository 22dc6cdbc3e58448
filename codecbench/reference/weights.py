"""The benchmark's seeded weights: one state dict that loads into the
program's model and into the reference.

Drawn on the device from one `torch.Generator` in three calls (one
uniform draw for every convolution and linear layer, one normal draw for
the relative-position tables, one uniform draw for the entropy
bottleneck's biases):

  * convolutions and linears: weight and bias uniform in
    +-1/sqrt(fan_in), fan_in being the weight's elements per output
    channel (torch's default scale);
  * relative-position tables: N(0, 0.02) clipped at +-0.04;
  * LayerNorms: weight 1, bias 0;
  * GDN: beta stored for 1, gamma for 0.1 I (stored as sqrt(v + pedestal));
  * entropy bottleneck: the factorized prior's initial state (matrices
    log(expm1(1 / 10^(1/5) / filters)), biases U(-0.5, 0.5), factors 0,
    quantiles -10, 0, 10: medians 0).

`gains` then multiply the weight and bias of the named modules, and
`scale_lift` is added to the last bias of every scale stack
(`cc_scale_transforms.<i>`'s last convolution). With STF's seed weights
every predicted scale sits at the table's floor (0.11) while y - mu
spreads with a standard deviation near 0.8, so a lane group escapes past
the device encoder's side channel and the fused encode tiers give the
call to the per-slice walk; a trained model predicts scales near y's
spread, and a lift of 1 puts these near 1. Likewise a seeded analysis
leaves the latents near zero (WACNN's y and both models' z have a
standard deviation near 0.01-0.06, so every symbol codes as 0 and the
stream says nothing of the analysis's precision); a gain on the layer
that makes the latent (g_a's last convolution, h_a's last) spreads them
over a few integers, as a trained model's are.

Every value is finally rounded to `dtype`, the type the configuration
serves its parameters in, and handed over in float32.
"""

import math

import torch
import torch.nn as nn

from . import models as ref_models

_PEDESTAL = (2 ** -18) ** 2


def _stored(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(v + _PEDESTAL, _PEDESTAL))


def make_state_dict(model: nn.Module, seed: int, device, scale_lift: float = 0.0,
                    dtype=torch.float32, gains=None) -> dict:
    """Seeded values for every parameter of `model` (a reference model;
    only its names and shapes are read, it may live on the meta device),
    as float32 tensors on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    params = dict(model.named_parameters())
    out = {}
    dense = []  # (name, shape, bound) drawn uniform in +-bound
    tables = []
    eb_biases = []
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            dense.append((prefix + "weight", m.weight.shape, bound))
            if m.bias is not None:
                dense.append((prefix + "bias", m.bias.shape, bound))
        elif isinstance(m, ref_models.WindowAttention):
            tables.append(prefix + "relative_position_bias_table")
        elif isinstance(m, nn.LayerNorm):
            out[prefix + "weight"] = torch.ones(m.weight.shape, device=device)
            out[prefix + "bias"] = torch.zeros(m.bias.shape, device=device)
        elif isinstance(m, ref_models.GDN):
            C = m.beta.shape[0]
            out[prefix + "beta"] = _stored(torch.ones(C, device=device))
            out[prefix + "gamma"] = _stored(0.1 * torch.eye(C, device=device))
        elif isinstance(m, ref_models.EntropyBottleneck):
            scale = 10.0 ** (1 / (len(m.dims) - 1))
            for i in range(len(m.dims) - 1):
                mat = getattr(m, f"_matrix{i}")
                out[f"{prefix}_matrix{i}"] = torch.full(
                    mat.shape, math.log(math.expm1(1 / scale / m.dims[i + 1])),
                    device=device)
                eb_biases.append(f"{prefix}_bias{i}")
                if i < len(m.dims) - 2:
                    out[f"{prefix}_factor{i}"] = torch.zeros(
                        getattr(m, f"_factor{i}").shape, device=device)
            q = torch.tensor([-10.0, 0.0, 10.0], device=device)
            out[prefix + "quantiles"] = q.reshape(1, 1, 3).expand(
                m.quantiles.shape).contiguous()

    def draw(names, shapes, fn):
        flat = fn(sum(math.prod(s) for s in shapes))
        at = 0
        for n, s in zip(names, shapes):
            k = math.prod(s)
            out[n] = flat[at:at + k].reshape(s)
            at += k

    draw([d[0] for d in dense], [d[1] for d in dense],
         lambda n: torch.rand(n, generator=gen, device=device) * 2 - 1)
    for name, _, bound in dense:
        out[name] = out[name] * bound
    draw(tables, [params[t].shape for t in tables],
         lambda n: (torch.randn(n, generator=gen, device=device) * 0.02).clamp(-0.04, 0.04))
    draw(eb_biases, [params[b].shape for b in eb_biases],
         lambda n: torch.rand(n, generator=gen, device=device) - 0.5)
    for prefix, gain in (gains or {}).items():
        hit = [k for k in (prefix + ".weight", prefix + ".bias") if k in out]
        if not hit:
            raise KeyError(f"gain for {prefix!r}: no such layer")
        for k in hit:
            out[k] = out[k] * gain
    if scale_lift:
        for i, stack in enumerate(model.cc_scale_transforms):
            last = len(stack) - 1
            out[f"cc_scale_transforms.{i}.{last}.bias"] += scale_lift
    missing = set(params) - set(out)
    if missing:
        raise KeyError(f"no recipe for parameters {sorted(missing)[:5]}")
    return {k: out[k].to(dtype).to(torch.float32).contiguous() for k in params}
