"""Host infrastructure of the port: the config system and the run logger.
Counterpart of `ei_nexus_tpu/utils/` (config, logger)."""

from .config import Config, load_config, save_config
from .logger import Logger, logger_from_config

__all__ = ["Config", "load_config", "save_config", "Logger",
           "logger_from_config"]
