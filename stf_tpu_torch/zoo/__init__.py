from .checkpoint import load_any_checkpoint, load_checkpoint, save_checkpoint
from .jax_import import state_dict_from_jax, strip_prefixes
from .registry import create_model, models

__all__ = [
    "create_model",
    "load_any_checkpoint",
    "load_checkpoint",
    "models",
    "save_checkpoint",
    "state_dict_from_jax",
    "strip_prefixes",
]
