"""JAX/flax params -> port state_dict (the inverse of
`stf_tpu/zoo/torch_import.py`, for all six registry models).

The input is a nested dict of NumPy arrays under flax names, as
``jax.tree_util.tree_map(np.asarray, params)`` gives; the output is a
state_dict for the port's registry model of that name (reference torch
key names). Layouts are inverted leaf by leaf: conv HWIO -> OIHW,
transposed conv (spatially flipped HWIO) -> IOHW, dense (in, out) ->
Linear (out, in), LayerNorm scale -> weight; "direct" leaves (GDN
beta/gamma, bias tables, bottleneck parameters) pass through, and CC_GD's
gates and masks go from (C,) to the reference's (1, C, 1, 1).

`strip_prefixes` is the reference's `load_pretrained` key clean-up, so a
reference `.pth.tar` state_dict loads into the port with
``model.load_state_dict(strip_prefixes(sd), strict=False)``; strict=False
because such files also hold derived buffers the port rebuilds itself
(CDF tables, `relative_position_index`, the reparametrizers' pedestals).
"""

import re
from typing import Dict, Tuple

import numpy as np
import torch


def strip_prefixes(state_dict: Dict) -> Dict:
    """Strip DataParallel's `module.` prefix, drop legacy `h_s.` keys, and
    rename legacy ParameterList bottleneck keys (`_biases.0` -> `_bias0`,
    same for matrices/factors)."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("h_s."):
            continue
        for plural, singular in (
            ("._biases.", "._bias"),
            ("._matrices.", "._matrix"),
            ("._factors.", "._factor"),
        ):
            if plural in k:
                head, idx = k.rsplit(".", 1)
                k = head.replace(plural[:-1], singular) + idx
        out[k] = v
    return out


def conv_kernel_to_torch(w: np.ndarray) -> np.ndarray:
    """flax conv HWIO -> torch OIHW."""
    return w.transpose(3, 2, 0, 1)


def deconv_kernel_to_torch(w: np.ndarray) -> np.ndarray:
    """flax ConvTranspose HWIO (spatially flipped) -> torch IOHW."""
    return np.ascontiguousarray(w[::-1, ::-1].transpose(2, 3, 0, 1))


def dense_kernel_to_torch(w: np.ndarray) -> np.ndarray:
    """flax Dense (in, out) -> torch Linear (out, in)."""
    return w.transpose(1, 0)


_TO_TORCH = {
    "conv": conv_kernel_to_torch,
    "deconv": deconv_kernel_to_torch,
    "dense": dense_kernel_to_torch,
}

# flax leaf -> torch leaf, by kind
_LEAF = {
    "conv": {"kernel": "weight", "bias": "bias"},
    "deconv": {"kernel": "weight", "bias": "bias"},
    "dense": {"kernel": "weight", "bias": "bias"},
    "ln": {"scale": "weight", "bias": "bias"},
}

# Win_noShift_Attention internals (WACNN g_a/g_s):
#   res_a{r}/Conv_{c}/Conv_0 -> conv_a.{r}.conv.{0|2|4}
#   win_attn/attn/...        -> conv_b.0.attn....
#   res_b{r}/Conv_{c}/Conv_0 -> conv_b.{r+1}.conv.{0|2|4}
#   proj/Conv_0              -> conv_b.4
_CONV_IDX = {"0": "0", "1": "2", "2": "4"}


def _attn_rules(f: str, t: str):
    rules = []
    for c_flax, c_torch in _CONV_IDX.items():
        rules += [
            (rf"{f}/res_a(\d)/Conv_{c_flax}/Conv_0",
             rf"{t}.conv_a.\1.conv.{c_torch}", "conv"),
            (rf"{f}/res_b(\d)/Conv_{c_flax}/Conv_0",
             rf"{t}.conv_b.\g<1>PLUS1.conv.{c_torch}", "conv"),
        ]
    rules += [
        (rf"{f}/win_attn/attn/qkv", rf"{t}.conv_b.0.attn.qkv", "dense"),
        (rf"{f}/win_attn/attn/proj", rf"{t}.conv_b.0.attn.proj", "dense"),
        (rf"{f}/win_attn/attn/relative_position_bias_table",
         rf"{t}.conv_b.0.attn.relative_position_bias_table", "direct"),
        (rf"{f}/proj/Conv_0", rf"{t}.conv_b.4", "conv"),
    ]
    return rules


def _hyper_synthesis_rules(name: str):
    """conv_0 -> seq0, up_k -> seq(2+4k).0 (subpel conv), conv_k -> seq(4k)."""
    return [
        (rf"{name}/conv_0/Conv_0", rf"{name}.0", "conv"),
        (rf"{name}/up_0/Conv_0/Conv_0", rf"{name}.2.0", "conv"),
        (rf"{name}/conv_1/Conv_0", rf"{name}.4", "conv"),
        (rf"{name}/up_1/Conv_0/Conv_0", rf"{name}.6.0", "conv"),
        (rf"{name}/conv_2/Conv_0", rf"{name}.8", "conv"),
    ]


def _bottleneck_rules():
    return [
        (r"entropy_bottleneck/matrix_(\d)", r"entropy_bottleneck._matrix\1",
         "direct"),
        (r"entropy_bottleneck/bias_(\d)", r"entropy_bottleneck._bias\1",
         "direct"),
        (r"entropy_bottleneck/factor_(\d)", r"entropy_bottleneck._factor\1",
         "direct"),
        (r"entropy_bottleneck/quantiles", r"entropy_bottleneck.quantiles",
         "direct"),
    ]


def _slice_stack_rules():
    return [(r"(cc_mean|cc_scale|lrp)_(\d+)/stack/conv_(\d)/Conv_0",
             r"\1_transforms.\2.SEQTIMES2", "conv")]


def _shared_rules():
    """The hyper, slice-transform and bottleneck rules of WACNN, STF and
    DYSTF."""
    rules = [(r"h_a/conv_(\d)/Conv_0", r"h_a.SEQTIMES2", "conv")]
    rules += _hyper_synthesis_rules("h_mean_s")
    rules += _hyper_synthesis_rules("h_scale_s")
    return rules + _slice_stack_rules() + _bottleneck_rules()


def wacnn_rules():
    """(flax path regex, torch key template, kind) for every WACNN leaf."""
    ga_seq = {"conv_0": 0, "gdn_0": 1, "conv_1": 2, "gdn_1": 3, "attn_0": 4,
              "conv_2": 5, "gdn_2": 6, "conv_3": 7, "attn_1": 8}
    gs_seq = {"attn_0": 0, "deconv_0": 1, "igdn_0": 2, "deconv_1": 3,
              "igdn_1": 4, "attn_1": 5, "deconv_2": 6, "igdn_2": 7,
              "deconv_3": 8}
    rules = []
    for name, idx in ga_seq.items():
        if name.startswith("conv"):
            rules.append((rf"g_a/{name}/Conv_0", rf"g_a.{idx}", "conv"))
        elif name.startswith("gdn"):
            rules.append((rf"g_a/{name}/(beta|gamma)", rf"g_a.{idx}.\1",
                          "direct"))
        else:
            rules += _attn_rules(f"g_a/{name}", f"g_a.{idx}")
    for name, idx in gs_seq.items():
        if name.startswith("deconv"):
            rules.append((rf"g_s/{name}/ConvTranspose_0", rf"g_s.{idx}",
                          "deconv"))
        elif name.startswith("igdn"):
            rules.append((rf"g_s/{name}/(beta|gamma)", rf"g_s.{idx}.\1",
                          "direct"))
        else:
            rules += _attn_rules(f"g_s/{name}", f"g_s.{idx}")
    return rules + _shared_rules()


def stf_rules():
    """(flax path regex, torch key template, kind) for every STF leaf:
    flax `layer_i/block_j` and `syn_layer_i/block_j` to torch
    `layers.i.blocks.j` and `syn_layers.i.blocks.j`; PatchMerging
    (`downsample`) and PatchSplit (`upsample`) both to `downsample`."""
    rules = [
        (r"patch_embed/proj/Conv_0", r"patch_embed.proj", "conv"),
        (r"patch_embed/norm", r"patch_embed.norm", "ln"),
        (r"end_conv_0/Conv_0", r"end_conv.0", "conv"),
        (r"end_conv_1/Conv_0", r"end_conv.2", "conv"),
    ]
    for f, t, resample in (("layer", "layers", "downsample"),
                           ("syn_layer", "syn_layers", "upsample")):
        rules += [
            (rf"{f}_(\d)/block_(\d)/norm([12])", rf"{t}.\1.blocks.\2.norm\3",
             "ln"),
            (rf"{f}_(\d)/block_(\d)/attn/(qkv|proj)",
             rf"{t}.\1.blocks.\2.attn.\3", "dense"),
            (rf"{f}_(\d)/block_(\d)/attn/relative_position_bias_table",
             rf"{t}.\1.blocks.\2.attn.relative_position_bias_table", "direct"),
            (rf"{f}_(\d)/block_(\d)/mlp/(fc[12])", rf"{t}.\1.blocks.\2.mlp.\3",
             "dense"),
            (rf"{f}_(\d)/{resample}/norm", rf"{t}.\1.downsample.norm", "ln"),
            (rf"{f}_(\d)/{resample}/reduction", rf"{t}.\1.downsample.reduction",
             "dense"),
        ]
    return rules + _shared_rules()


def dystf_rules():
    """STF's rules plus DYSTF's PredictorLG scorers (`in_conv` = LN,
    Linear, GELU; `out_conv` = Linear, GELU, Linear, GELU, Linear, ...)
    and the routed blocks' `fastmlp.fc1` (LN, Linear)."""
    p = r"layer_(\d)/predictor_(\d)"
    t = r"layers.\1.score_predictor.\2"
    return stf_rules() + [
        (rf"{p}/in_norm", rf"{t}.in_conv.0", "ln"),
        (rf"{p}/in_fc", rf"{t}.in_conv.1", "dense"),
        (rf"{p}/out_fc1", rf"{t}.out_conv.0", "dense"),
        (rf"{p}/out_fc2", rf"{t}.out_conv.2", "dense"),
        (rf"{p}/out_fc3", rf"{t}.out_conv.4", "dense"),
        (r"layer_(\d)/block_(\d)/fastmlp/norm",
         r"layers.\1.blocks.\2.fastmlp.fc1.0", "ln"),
        (r"layer_(\d)/block_(\d)/fastmlp/fc1",
         r"layers.\1.blocks.\2.fastmlp.fc1.1", "dense"),
    ]


def _swin_stage_rules(f: str, t: str, resample: str):
    """One stack of TBC's Swin stages: flax `<f>/stage_i/{block_j,
    downsample|upsample}` to torch `<t>.i.{blocks.j, downsample}` (the
    reference names PatchSplit `downsample` too)."""
    return [
        (rf"{f}/stage_(\d)/{resample}/norm", rf"{t}.\1.downsample.norm", "ln"),
        (rf"{f}/stage_(\d)/{resample}/reduction",
         rf"{t}.\1.downsample.reduction", "dense"),
        (rf"{f}/stage_(\d)/block_(\d)/norm([12])",
         rf"{t}.\1.blocks.\2.norm\3", "ln"),
        (rf"{f}/stage_(\d)/block_(\d)/attn/(qkv|proj)",
         rf"{t}.\1.blocks.\2.attn.\3", "dense"),
        (rf"{f}/stage_(\d)/block_(\d)/attn/relative_position_bias_table",
         rf"{t}.\1.blocks.\2.attn.relative_position_bias_table", "direct"),
        (rf"{f}/stage_(\d)/block_(\d)/mlp/(fc[12])",
         rf"{t}.\1.blocks.\2.mlp.\3", "dense"),
    ]


def tbc_rules():
    """TBC: merge-first `ana` -> `layers`, split-last `syn` ->
    `syn_layers`, the transformer hyper stacks under their own names."""
    rules = []
    for f, t, resample in (("ana", "layers", "downsample"),
                           ("syn", "syn_layers", "upsample"),
                           ("h_a", "h_a", "downsample"),
                           ("h_mean_s", "h_mean_s", "upsample"),
                           ("h_scale_s", "h_scale_s", "upsample")):
        rules += _swin_stage_rules(f, t, resample)
    return rules + _slice_stack_rules() + _bottleneck_rules()


def _cc_transform_rules():
    """CC's and CC_GD's g_a / g_s: conv (deconv) i at Sequential 2i, GDN
    (IGDN) i at 2i + 1."""
    return [
        (r"g_a/conv_(\d)/Conv_0", r"g_a.SEQTIMES2", "conv"),
        (r"g_a/gdn_(\d)/(beta|gamma)", r"g_a.SEQ2IPLUS1.\2", "direct"),
        (r"g_s/deconv_(\d)/ConvTranspose_0", r"g_s.SEQTIMES2", "deconv"),
        (r"g_s/igdn_(\d)/(beta|gamma)", r"g_s.SEQ2IPLUS1.\2", "direct"),
    ]


def cc_rules():
    """CC: conv/GDN g_a and g_s, ReLU hyper stacks (h_mean_s's two deconvs
    and conv at .0, .2, .4), 3-conv slice stacks."""
    return _cc_transform_rules() + [
        (r"h_a/conv_(\d)/Conv_0", r"h_a.SEQTIMES2", "conv"),
        (r"(h_mean_s|h_scale_s)/deconv_0/ConvTranspose_0", r"\1.0", "deconv"),
        (r"(h_mean_s|h_scale_s)/deconv_1/ConvTranspose_0", r"\1.2", "deconv"),
        (r"(h_mean_s|h_scale_s)/conv_0/Conv_0", r"\1.4", "conv"),
    ] + _slice_stack_rules() + _bottleneck_rules()


def cc_gd_rules():
    """CC_GD: CC's g_a and g_s; in the hyper and slice stacks conv i at
    Sequential 3i and its gate's `gate` and `mask` at 3i + 1 (kind "gate":
    (C,) -> (1, C, 1, 1)). Holds for the ungated `deps` build too, whose
    convs keep their positions."""
    rules = _cc_transform_rules()
    for i in range(3):
        rules += [
            (rf"h_a/conv_{i}/Conv_0", rf"h_a.{3 * i}", "conv"),
            (rf"h_a/gate_{i}/(gate|mask)", rf"h_a.{3 * i + 1}.\1", "gate"),
        ]
    for i, (nm, inner, kind) in enumerate((
        ("deconv_0", "ConvTranspose_0", "deconv"),
        ("deconv_1", "ConvTranspose_0", "deconv"),
        ("conv_2", "Conv_0", "conv"),
    )):
        rules += [
            (rf"(h_mean_s|h_scale_s)/{nm}/{inner}", rf"\1.{3 * i}", kind),
            (rf"(h_mean_s|h_scale_s)/gate_{i}/(gate|mask)",
             rf"\1.{3 * i + 1}.\2", "gate"),
        ]
    for j in range(3):
        rules.append((rf"(cc_mean|cc_scale|lrp)_(\d+)/conv_{j}/Conv_0",
                      rf"\1_transforms.\2.{3 * j}", "conv"))
    for j in range(2):
        rules.append((rf"(cc_mean|cc_scale|lrp)_(\d+)/gate_{j}/(gate|mask)",
                      rf"\1_transforms.\2.{3 * j + 1}.\3", "gate"))
    return rules + _bottleneck_rules()


_RULES = {"cnn": wacnn_rules, "stf": stf_rules, "tbc": tbc_rules,
          "dystf": dystf_rules, "cc": cc_rules, "cc_gd": cc_gd_rules}


def _translate(rules, path: Tuple[str, ...]):
    joined = "/".join(path)
    for pattern, template, kind in rules:
        m = re.fullmatch(pattern, joined)
        if m:
            return _fix_key(m.expand(template), joined), kind
    return None, None


def _fix_key(key: str, path_joined: str) -> str:
    """Template placeholders: SEQTIMES2 (conv_i -> seq 2*i), SEQ2IPLUS1
    (gdn_i -> seq 2*i + 1), PLUS1 (residual unit index shift)."""
    if "SEQTIMES2" in key:
        m = re.search(r"conv_(\d)", path_joined)
        key = key.replace("SEQTIMES2", str(2 * int(m.group(1))))
    if "SEQ2IPLUS1" in key:
        m = re.search(r"i?gdn_(\d)", path_joined)
        key = key.replace("SEQ2IPLUS1", str(2 * int(m.group(1)) + 1))
    m = re.search(r"(\d)PLUS1", key)
    if m:
        key = key.replace(m.group(0), str(int(m.group(1)) + 1))
    return key


def state_dict_from_jax(params, model: str = "cnn") -> Dict[str, torch.Tensor]:
    """flax params (nested dict of arrays) of registry model `model` (any
    of the six names) -> port state_dict. Raises KeyError for a leaf no
    rule maps."""
    rules = _RULES[model]()
    flat = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            flat[path] = np.asarray(tree)

    walk(params, ())
    out = {}
    for path, leaf in flat.items():
        key, kind = _translate(rules, path)
        if kind == "gate":
            leaf = leaf.reshape(1, -1, 1, 1)
        if key is None:
            base, kind = _translate(rules, path[:-1])
            if base is None or kind == "direct":
                raise KeyError(f"no torch mapping for {'/'.join(path)!r}")
            key = f"{base}.{_LEAF[kind][path[-1]]}"
            if path[-1] == "kernel":
                leaf = _TO_TORCH[kind](leaf)
        out[key] = torch.from_numpy(np.array(leaf))  # a writable copy
    return out
