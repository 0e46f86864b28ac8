from .defaults import get_cfg
from .node import ConfigNode
from .parser import arg_parser, load_config, overwrite_default_configs

__all__ = ["get_cfg", "ConfigNode", "arg_parser", "load_config",
           "overwrite_default_configs"]
