"""Deterministic synthetic data (counterpart of ``repro.data.pipeline``).

Batch t of run seed s is a pure function of (s, t), drawn by numpy from the
same streams as the JAX package (``default_rng((seed, step, 7))`` for the
images and volumes, ``default_rng((seed, step))`` for the tokens), in the
same order, so both get bit-identical batches. The ``lm`` source (the LMs),
``image`` (ResNet, VGG16) and ``volume`` (CosmoFlow) are ported; the
multimodal sources come with the models that read them.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    kind: str                 # "lm" | "image" | "volume" (the kinds ported)
    batch: int
    seq_len: int = 0
    vocab: int = 0
    image: int = 0
    channels: int = 3
    classes: int = 0
    n_targets: int = 0
    seed: int = 0


class TokenSource:
    """Synthetic LM stream: uniform first tokens, then a fixed random bigram
    map (drawn from ``seed``) followed with probability 0.85 and a uniform
    token otherwise, so a small model's loss visibly falls. int32 ids."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._next = rng.integers(0, cfg.vocab, size=(cfg.vocab,),
                                  dtype=np.int32)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        first = rng.integers(0, cfg.vocab, size=(cfg.batch, 1),
                             dtype=np.int32)
        toks = [first[:, 0]]
        noise = rng.random((cfg.batch, cfg.seq_len - 1)) < 0.15
        for t in range(cfg.seq_len - 1):
            nxt = self._next[toks[-1]]
            rand = rng.integers(0, cfg.vocab, size=(cfg.batch,),
                                dtype=np.int32)
            toks.append(np.where(noise[:, t], rand, nxt).astype(np.int32))
        return {"tokens": np.stack(toks, axis=1)}


class SyntheticSource:
    """Gaussian NHWC images with uniform integer labels, or Gaussian NDHWC
    volumes with regression targets."""

    KINDS = ("image", "volume")

    def __init__(self, cfg: DataConfig):
        if cfg.kind not in self.KINDS:
            raise ValueError(f"data kind {cfg.kind!r} is not ported yet; "
                             f"ported: {list(self.KINDS)}")
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 7))
        if cfg.kind == "image":
            return {"images": rng.standard_normal(
                        (cfg.batch, cfg.image, cfg.image, cfg.channels),
                        dtype=np.float32),
                    "labels": rng.integers(0, cfg.classes, (cfg.batch,),
                                           dtype=np.int32)}
        x = rng.standard_normal(
            (cfg.batch, cfg.image, cfg.image, cfg.image, cfg.channels),
            dtype=np.float32)
        # CosmoFlow-style targets: fixed functionals of the volume
        t = np.stack([x[:, ::2].mean((1, 2, 3, 4)),
                      x[:, :, ::2].std((1, 2, 3, 4)),
                      x.mean((1, 2, 3, 4)),
                      x.std((1, 2, 3, 4))], axis=1)[:, :cfg.n_targets]
        return {"images": x, "targets": t.astype(np.float32)}


def make_source(cfg: DataConfig):
    return TokenSource(cfg) if cfg.kind == "lm" else SyntheticSource(cfg)


class Loader:
    """Iterates (seed, step)-addressable batches, placed on ``device``."""

    def __init__(self, cfg: DataConfig, device: torch.device):
        self.source = make_source(cfg)
        self.device = device

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.source.batch_at(step).items()}
