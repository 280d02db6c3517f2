"""Which layers each rank runs in an LM pipeline (counterpart of
``repro.parallel.schedules.stages``).

The reference shards an LM's stacked (L, ...) layer parameters over the
stage axis: ``stack_stage_bounds`` gathers stage i's layers
[bounds[i], bounds[i+1]) into slot rows padded to the longest stage, and
``stack_virtual_stage_bounds`` gives chunk j = q·p + r of the v·p chunks
to rank r, slot q. Padded slots repeat the stage's last layer and a mask
turns them into identity (``make_masked_stage_fn``), because every rank
of a ``shard_map`` scans the same shapes. Eager torch runs each rank's
own layers in a loop, so the port keeps only the assignment those layouts
encode, with no padding and no mask: the numbers are the same, since a
padded slot computes nothing.

``block_costs_from_stats`` is the reference's: the per-layer fw+bw cost
vector the partitioner cuts on, from the oracle's layer table.
"""
from __future__ import annotations

import re

import numpy as np


def stack_stage_bounds(bounds) -> list[tuple[int, ...]]:
    """The layers of each stage: entry i is (bounds[i], …, bounds[i+1]−1),
    the valid slots of the reference's padded stage i."""
    bounds = tuple(int(b) for b in bounds)
    stages = [tuple(range(lo, hi)) for lo, hi in zip(bounds, bounds[1:])]
    if not all(stages):
        raise ValueError(f"empty stage in bounds {bounds}")
    return stages


def stack_virtual_stage_bounds(bounds, n_stages: int,
                               virtual_stages: int) -> list[list[tuple]]:
    """The layers of each rank's slots under the interleaved schedule:
    entry [r][q] holds chunk q·p + r of the v·p contiguous chunks."""
    p, v = int(n_stages), int(virtual_stages)
    chunks = stack_stage_bounds(bounds)
    if len(chunks) != p * v:
        raise ValueError(f"{len(chunks)} chunks in bounds for p={p}, v={v}")
    return [[chunks[q * p + r] for q in range(v)] for r in range(p)]


def block_costs_from_stats(stats, n_layers: int) -> np.ndarray:
    """Per-layer fw+bw FLOP cost from the oracle's layer stats.

    ``lm_stats`` names per-layer entries ``L{i}.<part>`` (attn, ffn, ssm);
    a layer's cost sums its parts, the backward from the stat's exact value
    where the extractor recorded one, else 2× the forward. Entries without
    an ``L{i}.`` prefix (embedding, head) are left out. Uniform costs when
    no entry names a layer."""
    costs = np.zeros(n_layers)
    for st in stats:
        m = re.match(r"L(\d+)\.", st.name)
        if m and int(m.group(1)) < n_layers:
            bwd = st.flops_bwd_exact or 2.0 * st.flops_fwd
            costs[int(m.group(1))] += st.flops_fwd + bwd
    return costs if costs.any() else np.ones(n_layers)
