from .bound_ops import LowerBound, lower_bound
from .ops import ste_round
from .parametrizers import NonNegativeParametrizer

__all__ = ["LowerBound", "lower_bound", "ste_round", "NonNegativeParametrizer"]
