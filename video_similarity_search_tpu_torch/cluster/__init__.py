from .finch import FINCH
from .fit import METHODS, fit_cluster

__all__ = ["FINCH", "METHODS", "fit_cluster"]
