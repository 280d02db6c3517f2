"""Deterministic synthetic data (counterpart of ``repro.data.pipeline``).

Batch t of run seed s is a pure function of (s, t), drawn by numpy from the
same ``default_rng((seed, step, 7))`` stream as the JAX package, so both get
bit-identical batches. Only the ``image`` source is ported so far; token,
volume and multimodal sources come with their models.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    kind: str                 # "image" (the only kind ported so far)
    batch: int
    image: int = 0
    channels: int = 3
    classes: int = 0
    seed: int = 0


class SyntheticSource:
    """Gaussian NHWC images with uniform integer labels."""

    def __init__(self, cfg: DataConfig):
        if cfg.kind != "image":
            raise ValueError(f"data kind {cfg.kind!r} is not ported yet; "
                             f"ported: ['image']")
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 7))
        return {"images": rng.standard_normal(
                    (cfg.batch, cfg.image, cfg.image, cfg.channels),
                    dtype=np.float32),
                "labels": rng.integers(0, cfg.classes, (cfg.batch,),
                                       dtype=np.int32)}


class Loader:
    """Iterates (seed, step)-addressable batches, placed on ``device``."""

    def __init__(self, cfg: DataConfig, device: torch.device):
        self.source = SyntheticSource(cfg)
        self.device = device

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.source.batch_at(step).items()}
