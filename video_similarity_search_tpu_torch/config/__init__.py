from .defaults import get_cfg
from .node import ConfigNode

__all__ = ["get_cfg", "ConfigNode"]
