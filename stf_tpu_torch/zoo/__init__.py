from .jax_import import state_dict_from_jax, strip_prefixes
from .registry import create_model, models

__all__ = ["create_model", "models", "state_dict_from_jax", "strip_prefixes"]
