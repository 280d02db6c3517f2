"""Traffic model for serving (counterpart of ``repro.serve.traffic``):
arrival rate × sequence-length distribution.

One ``TrafficModel`` is both the analytic input to the serving oracle
(``serve/oracle.py`` prices TTFT and latency percentiles under it) and a
synthetic trace generator for the engine (``trace()`` draws Poisson
arrivals with jittered prompt lengths), so the oracle and the measured
replay read the same workload description. ``trace`` makes the reference's
numpy draws in the reference's order: the same seed gives the same
requests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .engine import Request

__all__ = ["TrafficModel"]


@dataclass(frozen=True)
class TrafficModel:
    """Open-loop request stream against the whole deployment.

    ``rate``: mean arrivals per second (Poisson). ``prompt_len`` /
    ``gen_len``: mean lengths; ``spread`` jitters prompts uniformly over
    [mean·(1−spread), mean·(1+spread)] (generation lengths stay fixed, so
    the token count of a trace, and thus its measured tok/s, is fixed by
    its size).
    """

    rate: float
    prompt_len: int
    gen_len: int
    spread: float = 0.5

    def __post_init__(self):
        if self.rate <= 0 or self.prompt_len < 1 or self.gen_len < 1:
            raise ValueError(f"degenerate traffic model {self}")
        if not 0 <= self.spread < 1:
            raise ValueError(f"spread must be in [0, 1), got {self.spread}")

    @property
    def mean_context(self) -> float:
        """Average decode context length (prompt + half the generation)."""
        return self.prompt_len + self.gen_len / 2

    def trace(self, n: int, vocab: int, seed: int = 0) -> "list[Request]":
        """``n`` requests with Poisson arrivals at ``rate`` req/s."""
        rng = np.random.default_rng(seed)
        arrivals = np.cumsum(rng.exponential(1.0 / self.rate, size=n))
        lo = max(1, int(round(self.prompt_len * (1 - self.spread))))
        hi = max(lo, int(round(self.prompt_len * (1 + self.spread))))
        lens = rng.integers(lo, hi + 1, size=n)
        return [
            Request(rid=i,
                    prompt=rng.integers(1, vocab, size=int(lens[i]),
                                        dtype=np.int32),
                    max_new=self.gen_len,
                    arrival=float(arrivals[i]))
            for i in range(n)
        ]
