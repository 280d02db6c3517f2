"""Pipeline stage partitioner — contiguous min-max DP over per-layer costs
(the port's copy of ``repro.core.partition``).

The paper's Table-3 "Layer" row assumes balanced stages (max stage ≈ total/p,
the §5.3.3 workload-balancing caveat). Real CNN layer tables are heavily
skewed (early convs dominate FLOPs, late FCs dominate weights), so this
module computes the *optimal contiguous partition*: split G layers into k
stages minimizing the bottleneck stage's cost. Both Dryden et al. and Jia et
al. show this load imbalance dominates layer-partitioned CNN training.

Used by
  * ``oracle._eval`` — the pipeline row's ``max FW_Gi + max BW_Gi`` terms and
    the stage-boundary activation sizes come from the DP cut points instead
    of ``total/p`` and ``max_l |y_l|``;
  * the JAX package's ``parallel/pipeline.make_pipeline_train_step`` — its
    executable GPipe schedule cuts its stages with the same partitioner
    (the port's pipeline executor comes with a later slice).

Pure numpy: usable from the allocation-free oracle path.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StagePartition:
    """A contiguous partition of ``n`` layers into ``k`` non-empty stages.

    ``bounds`` has k+1 entries: stage i owns layers [bounds[i], bounds[i+1]).
    ``max_cost`` is the bottleneck stage's total cost under the partitioning
    cost vector (the quantity the DP minimized).
    """

    bounds: tuple[int, ...]
    max_cost: float

    @property
    def k(self) -> int:
        return len(self.bounds) - 1

    def counts(self) -> tuple[int, ...]:
        return tuple(self.bounds[i + 1] - self.bounds[i]
                     for i in range(self.k))


def balanced_partition(n: int, k: int) -> StagePartition:
    """Equal-layer-COUNT split (the naive 'balanced' baseline the oracle
    previously assumed): stage sizes differ by at most one layer."""
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k={k} <= n={n}")
    base, extra = divmod(n, k)
    bounds, at = [0], 0
    for i in range(k):
        at += base + (1 if i < extra else 0)
        bounds.append(at)
    return StagePartition(tuple(bounds), float("nan"))


def min_max_partition(costs, k: int) -> StagePartition:
    """Optimal contiguous split of ``costs`` into ``k`` non-empty stages
    minimizing the max stage sum (classic linear-partition DP, O(k·n²) with
    prefix sums — layer tables are ≤ a few hundred entries).

    Ties break toward the earliest cut points, so the result is
    deterministic and matches a left-to-right brute-force enumeration.
    """
    c = np.asarray(costs, np.float64)
    n = int(c.size)
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k={k} <= n={n} layers")
    if np.any(c < 0):
        raise ValueError("stage costs must be non-negative")
    prefix = np.concatenate([[0.0], np.cumsum(c)])
    if k == 1:
        return StagePartition((0, n), float(prefix[n]))
    # f[i] = min over partitions of layers [0, i) into the current number of
    # stages of the max stage sum; cut[j][i] = argmin split point
    f = prefix[1:].copy()                      # 1 stage over [0, i)
    cuts = np.zeros((k, n + 1), np.int64)
    for j in range(2, k + 1):
        g = np.full(n + 1, np.inf)
        # stage j spans [m, i); need m >= j-1 (non-empty earlier stages)
        for i in range(j, n + 1):
            best, arg = np.inf, j - 1
            for m in range(j - 1, i):
                cand = max(f[m - 1], prefix[i] - prefix[m])
                if cand < best - 1e-18:
                    best, arg = cand, m
            g[i] = best
            cuts[j - 1, i] = arg
        f = g[1:]
    bounds = [n]
    for j in range(k, 1, -1):
        bounds.append(int(cuts[j - 1, bounds[-1]]))
    bounds.append(0)
    bounds = tuple(reversed(bounds))
    return StagePartition(bounds, float(f[n - 1]))


def stage_sums(values, bounds) -> np.ndarray:
    """Per-stage sums of ``values`` under ``bounds`` (length k array)."""
    v = np.asarray(values, np.float64)
    prefix = np.concatenate([[0.0], np.cumsum(v)])
    b = np.asarray(bounds, np.int64)
    return prefix[b[1:]] - prefix[b[:-1]]


def cut_values(values, bounds) -> np.ndarray:
    """``values`` at the stage-boundary layers: the activation leaving stage
    i is the output of its LAST layer (index bounds[i+1]-1), for every
    internal boundary. Empty for a single stage."""
    v = np.asarray(values, np.float64)
    b = np.asarray(bounds, np.int64)
    if len(b) <= 2:
        return np.zeros(0)
    return v[b[1:-1] - 1]
