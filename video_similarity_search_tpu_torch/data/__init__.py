from .augment import normalization_constants, normalize_only

__all__ = ["normalization_constants", "normalize_only"]
