"""Checkpointing (counterpart of ``repro.checkpoint``)."""
from .checkpointing import Checkpointer, config_hash

__all__ = ["Checkpointer", "config_hash"]
