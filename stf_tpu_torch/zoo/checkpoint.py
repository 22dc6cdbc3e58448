"""Eval checkpoints (port of `stf_tpu/zoo/checkpoint.py`) in torch's format.

`save_checkpoint` writes a model's `state_dict` (the reference's torch
names) with `torch.save`, plus the JAX package's sidecar `path + ".json"`,
{"model", "kwargs"}. `load_checkpoint` reads three kinds of file, all
through `blob.get("state_dict", blob)`:
  * the port's own files;
  * the trainer's `checkpoint.pth.tar` / `checkpoint_best.pth.tar`
    (`stf_tpu_torch/training/checkpoint.py`), whose dict carries the
    `state_dict` and the meta `model`;
  * reference-layout `.pth.tar` files: a DataParallel `module.` prefix and
    the legacy `_biases.` / `_matrices.` / `_factors.` keys, cleaned by
    `strip_prefixes`, and the buffers the reference registers but the port
    derives itself (`_DERIVED`), dropped.
The load is strict: any other missing or unexpected key raises. The JAX
package reads the port's files through its own `load_any_checkpoint`.
"""

import json
import os
from typing import Optional

import torch

from ..models.codec import default_device
from .jax_import import strip_prefixes
from .registry import models

# last key components of buffers a reference state_dict holds that the port
# rebuilds from the parameters: the entropy models' CDF tables and scale
# table, LowerBound's and NonNegativeParametrizer's constants, the window
# attention's relative-position index and shift mask; and CC_GD's gate
# `score`s, the pruning loop's Taylor sums, which the eval model does not
# hold
_DERIVED = frozenset((
    "_quantized_cdf", "_offset", "_cdf_length", "scale_table", "bound",
    "pedestal", "relative_position_index", "attn_mask", "score",
))


def save_checkpoint(path: str, model_name: str, model,
                    model_kwargs: Optional[dict] = None) -> None:
    """Write `model`'s state_dict to `path` and the sidecar `path.json`
    naming the registry model and its constructor kwargs."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    with open(path + ".json", "w") as f:
        json.dump({"model": model_name, "kwargs": model_kwargs or {}}, f)


def load_checkpoint(path: str, model_name: Optional[str] = None,
                    device=None, **model_kwargs):
    """The registry model a checkpoint holds, its weights loaded strictly,
    in eval mode on `device` (None: the card; raises where there is none).
    The model's name and kwargs come from the sidecar where there is one;
    `model_name` and `model_kwargs` override them. A trainer checkpoint
    names its model in its own dict."""
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: a flax msgpack checkpoint; stf_tpu_torch reads torch "
            "files (.pth, .pth.tar, .pt). The JAX package reads the port's "
            "files through stf_tpu.zoo.load_any_checkpoint"
        )
    if os.path.exists(path + ".deps.json"):
        raise NotImplementedError(
            f"{path}: a pruned cc_gd export (.deps.json); reading one comes "
            "with train_gd's prune_export, ROADMAP A.8 (CC_GD(deps=...) "
            "builds the pruned widths)"
        )
    kwargs = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
        model_name = model_name or meta["model"]
        kwargs = meta.get("kwargs", {})
    kwargs.update(model_kwargs)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model_name = model_name or blob.get("model")
    if model_name is None:
        raise ValueError(f"{path}: model_name required (no sidecar and no "
                         "model in the checkpoint)")
    model = models[model_name](**kwargs)
    state = strip_prefixes(blob.get("state_dict", blob))
    model.load_state_dict({k: v for k, v in state.items()
                           if k.rsplit(".", 1)[-1] not in _DERIVED})
    device = default_device() if device is None else torch.device(device)
    return model.to(device).eval()


def load_any_checkpoint(path: str, model_name: Optional[str] = None,
                        device=None, **model_kwargs):
    """The format dispatch `rd_compare` calls (the JAX package's name):
    every format the port reads is a torch file, so this is
    `load_checkpoint`."""
    return load_checkpoint(path, model_name, device, **model_kwargs)
