from .finch import FINCH
from .fit import METHODS, fit_cluster
from .kmeans import kmeans, spherical_kmeans

__all__ = ["FINCH", "METHODS", "fit_cluster", "kmeans", "spherical_kmeans"]
