from .base import ChannelARModel, init_weights
from .cc import CC
from .cc_gd import CC_GD
from .cnn import WACNN
from .codec import Codec
from .dystf import DYSTF
from .stf import SymmetricalTransFormer
from .tbc import TransformerBasedCoding

__all__ = ["CC", "CC_GD", "ChannelARModel", "Codec", "DYSTF",
           "SymmetricalTransFormer", "TransformerBasedCoding", "WACNN",
           "init_weights"]
