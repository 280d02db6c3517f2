from . import cnn_archs, lm_archs  # noqa: F401  (populate the registry)
from .base import ArchConfig, get_config
