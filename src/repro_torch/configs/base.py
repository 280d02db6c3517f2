"""Config plumbing: arch descriptors and the registry (counterpart of
``repro.configs.base``; the strategy fields and the input-shape cells come
with the parallel slice)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class ArchConfig:
    """A registered architecture: full config + reduced smoke config."""

    name: str
    family: str                    # "cnn" | "lm" (the families ported so far)
    model: Any
    smoke_model: Any
    source: str                    # provenance of the configuration


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()

