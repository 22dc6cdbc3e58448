from .base import ChannelARModel, init_weights
from .cnn import WACNN
from .codec import Codec
from .stf import SymmetricalTransFormer

__all__ = ["ChannelARModel", "Codec", "SymmetricalTransFormer", "WACNN",
           "init_weights"]
