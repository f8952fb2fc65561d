from .hocon import ConfigFactory, ConfigTree, dump_config
from . import constants

__all__ = ["ConfigFactory", "ConfigTree", "dump_config", "constants"]
