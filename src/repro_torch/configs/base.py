"""Config plumbing: arch descriptors, input shapes and the registry
(counterpart of ``repro.configs.base``). ``strategy``/``shape_strategy``
are what the auto-tuner reads: the arch's rules table, which wins the
tuner's ties and absorbs infeasibility (``core.autotune``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    """A registered architecture: full config + reduced smoke config.

    ``strategy``: the default parallel strategy (a rules-table name of
    ``parallel/strategies.py``); per-shape overrides in ``shape_strategy``.
    """

    name: str
    family: str                    # "cnn" | "lm" (the families ported so far)
    model: Any
    smoke_model: Any
    source: str                    # provenance of the configuration
    strategy: str = "df_zero3"
    shape_strategy: dict = field(default_factory=dict)

    def strategy_for(self, shape: str) -> str:
        return self.shape_strategy.get(shape, self.strategy)


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
