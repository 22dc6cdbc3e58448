"""The comparison that decides `correct`, and its control.

`judge` holds what a codec produced for a batch against the reference
(`models.py`) at float32, reading the codec's outputs only to judge them:

  * z_gap: the widest distance by which the reference's z - medians lies
    outside the rounding interval of the z symbol the stream carries
    (|z - med - z_sym| - 0.5, the largest over the batch): the analysis,
    z's quantisation and z's coding;
  * y_gap: the same for every y symbol the stream carries, against the
    reference's y and its own mean mu, which it computes from the stream's
    z and the stream's earlier slices (teacher forcing, as a served
    model's tokens are fed back to its reference): the analysis, the
    hyper synthesis, the slice walk's means and the lane stream;
  * idx_gap: the widest distance, in natural log of the scale, by which the
    reference's scale lies outside the scale-table interval of the index
    the encoder used (table[i-1] < s <= table[i]): the walk's scales;
  * xhat_gap: the largest |x_hat - reference x_hat| over the batch, the
    reference synthesising the stream's symbols plus its own means and
    residual predictions: the synthesis;
  * symbol_mismatch: decoded y symbols that differ from the encoded ones
    (the lane stream's round trip), exact.

`control_outputs` is the reference put in the codec's place at the next
lower precision than the configuration states: products of the bf16
analysis in fp8 (e4m3, one scale a tensor), the float32 (TF32-off)
coding steps in TF32 (inputs rounded to 10 mantissa bits). Both
roundings are written out, so the control computes the same on the CPU
and on the card.
"""

import torch

from . import models as ref_models


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    if t.dtype != torch.float32 or t.device.type == "meta":
        return t
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), back in t's dtype."""
    if t.device.type == "meta":
        return t
    s = t.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def _nchw(t, device):
    return t.to(device).permute(0, 3, 1, 2).float()


@torch.no_grad()
def judge(ref: ref_models.ChannelAR, x_u8, outs: dict, device, block: int = 4) -> dict:
    """The five numbers for one batch: x_u8 (B, H, W, 3) uint8; `outs` the
    codec's "z_sym" (B, zh, zw, N) ints, per-slice NHWC "q_enc",
    "idx_enc" and "q_dec", and "x_hat" (B, H, W, 3)."""
    table = ref_models.scale_table().to(device).log()
    med = ref.entropy_bottleneck.medians().float()[None, :, None, None]
    worst = {"z_gap": float("-inf"), "y_gap": float("-inf"), "idx_gap": 0.0,
             "xhat_gap": 0.0, "symbol_mismatch": 0}
    B = x_u8.shape[0]
    for lo in range(0, B, block):
        hi = min(lo + block, B)
        x = _nchw(x_u8[lo:hi], device) / 255.0
        y, z = ref.analyze(x)
        zs = _nchw(outs["z_sym"][lo:hi], device)
        worst["z_gap"] = max(worst["z_gap"],
                             float(((z - med - zs).abs() - 0.5).max()))
        lm, ls = ref.hyper(zs + med, y.shape[2:])
        decoded = []
        for i, y_i in enumerate(ref.split(y)):
            mu, scale, ms = ref.slice_mu_scale(i, lm, ls, ref.support(decoded))
            q = _nchw(outs["q_dec"][i][lo:hi], device)
            worst["y_gap"] = max(worst["y_gap"],
                                 float(((y_i - mu - q).abs() - 0.5).max()))
            idx = _nchw(outs["idx_enc"][i][lo:hi], device).long()
            ls_ = scale.clamp_min(0.11).log()
            lower = torch.where(idx > 0, table[(idx - 1).clamp_min(0)] - ls_,
                                torch.zeros_like(ls_))
            upper = torch.where(idx < len(table) - 1,
                                ls_ - table[idx.clamp_max(len(table) - 1)],
                                torch.zeros_like(ls_))
            worst["idx_gap"] = max(worst["idx_gap"],
                                   float(torch.maximum(lower, upper).max()))
            worst["symbol_mismatch"] += int(
                (outs["q_enc"][i][lo:hi].to(device) != outs["q_dec"][i][lo:hi].to(device)).sum())
            y_hat = q + mu
            decoded.append(y_hat + ref.lrp(i, ms, y_hat))
        x_ref = ref.synthesize(torch.cat(decoded, 1)).permute(0, 2, 3, 1)
        worst["xhat_gap"] = max(worst["xhat_gap"], float(
            (outs["x_hat"][lo:hi].to(device).float() - x_ref).abs().max()))
        del y, z, lm, ls, decoded, x_ref
    return worst


@torch.no_grad()
def control_outputs(ctrl: ref_models.ChannelAR, x_u8, device, block: int = 4) -> dict:
    """What a codec built from the reference at the control's precision
    would produce for x_u8: the encoder's z and y symbols and scale
    indexes (rounded against its own means), and the decoder's x_hat."""
    table = ref_models.scale_table().to(device)
    med = ctrl.entropy_bottleneck.medians().float()[None, :, None, None]
    out = {"z_sym": [], "q_enc": [], "idx_enc": [], "x_hat": []}
    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
    for lo in range(0, x_u8.shape[0], block):
        x = _nchw(x_u8[lo:lo + block], device) / 255.0
        y, z = ctrl.analyze(x)
        zs = torch.round(z - med)
        lm, ls = ctrl.hyper(zs + med, y.shape[2:])
        decoded, qs, idxs = [], [], []
        for i, y_i in enumerate(ctrl.split(y)):
            mu, scale, ms = ctrl.slice_mu_scale(i, lm, ls, ctrl.support(decoded))
            q = torch.round(y_i - mu)
            qs.append(nhwc(q).int())
            idxs.append(nhwc(torch.bucketize(scale.clamp_min(0.11).contiguous(),
                                             table[:-1])).int())
            y_hat = q + mu
            decoded.append(y_hat + ctrl.lrp(i, ms, y_hat))
        out["z_sym"].append(nhwc(zs).int())
        out["q_enc"].append(qs)
        out["idx_enc"].append(idxs)
        out["x_hat"].append(nhwc(ctrl.synthesize(torch.cat(decoded, 1))))
    cat = lambda ts: torch.cat(ts, 0)  # noqa: E731
    q = [cat(s) for s in zip(*out["q_enc"])]
    return {"z_sym": cat(out["z_sym"]), "q_enc": q, "q_dec": q,
            "idx_enc": [cat(s) for s in zip(*out["idx_enc"])],
            "x_hat": cat(out["x_hat"])}


def control_model(model: str, arch: dict, state: dict, param_dtype, device):
    """The reference with the control's roundings: fp8 in the analysis
    (g_a / the Swin analysis and h_a), TF32 everywhere else."""
    ctrl = ref_models.build(model, arch, param_dtype, device="meta")
    ctrl = ctrl.to_empty(device=device)
    ctrl.load_state_dict(state)
    ref_models.set_rounding(ctrl, tf32)
    for part in ctrl.analysis_modules():
        ref_models.set_rounding(part, fp8)
    return ctrl.eval()


def reference_model(model: str, arch: dict, state: dict, param_dtype, device):
    ref = ref_models.build(model, arch, param_dtype, device="meta")
    ref = ref.to_empty(device=device)
    ref.load_state_dict(state)
    return ref.eval()


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number compared is within its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
