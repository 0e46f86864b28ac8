from .device import resolve_device
from .meters import append_metric_line

__all__ = ["resolve_device", "append_metric_line"]
