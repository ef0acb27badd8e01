"""Host infrastructure of the port: the config system and the run logger;
beside them `setup` (seeds, determinism), `profiling` (traces, step
timer), `image_io` and `visualize` (numpy and cv2). Counterpart of
`ei_nexus_tpu/utils/` but for its TPU-only modules (tunnel, cache,
platform)."""

from .config import Config, load_config, save_config
from .logger import Logger, logger_from_config

__all__ = ["Config", "load_config", "save_config", "Logger",
           "logger_from_config"]
