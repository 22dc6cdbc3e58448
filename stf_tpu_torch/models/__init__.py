from .base import ChannelARModel, init_weights
from .cnn import WACNN
from .codec import Codec

__all__ = ["ChannelARModel", "Codec", "WACNN", "init_weights"]
