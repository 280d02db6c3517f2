"""Strategy advisor — the oracle front-end (paper §4.1 use case 1); the
port's copy of ``repro.core.advisor``.

Given (model stats, system, batch, PE budget, memory cap), evaluate the
strategies × group splits lattice with the vectorized sweep engine
(sweep.py), drop infeasible points (scaling limits, memory), and rank the
rest by projected per-iteration time. Also emits the breakdown table the
paper's Fig. 3 plots.
"""
from __future__ import annotations

from dataclasses import dataclass

from .layer_stats import LayerStat
from .oracle import OracleConfig, Projection, TimeModel
from .sweep import factor_pairs, sweep


@dataclass
class Recommendation:
    best: Projection | None
    ranked: list[Projection]
    rejected: list[tuple[Projection, str]]


def _split_candidates(p: int):
    """Candidate (p1 data-groups, p2 model-width) factorizations: ALL divisor
    pairs of p (exhaustive — non-pow2 hybrid splits like 12 = 3×4 included)."""
    return factor_pairs(p)


def advise(stats: list[LayerStat], tm: TimeModel, cfg: OracleConfig, p: int,
           mem_cap: float | None = None,
           strategies=("data", "spatial", "pipeline", "filter", "channel",
                       "df", "ds", "ep", "summa"), cluster=None) -> Recommendation:
    """Rank strategies at p. ``cluster`` (a ClusterSpec) additionally
    rejects splits its torus topology cannot host — they land in
    ``rejected`` with the placement reason, like any scaling limit.
    The lattice includes the 2D grid points: "summa" fans over every
    (p1, p2r·p2c) factorization, and the headline ranking keeps its best
    grid like any other strategy's best split."""
    mem_cap = mem_cap or tm.system.mem_capacity
    res = sweep(stats, tm, cfg, [p], strategies, mem_cap=mem_cap,
                cluster=cluster)
    ranked, rejected = [], []
    for i, proj in enumerate(res.to_projections()):
        if not proj.feasible:
            rejected.append((proj, f"scaling limit: {proj.limit}"))
        elif not res.fits[i]:
            rejected.append(
                (proj, f"memory {proj.mem_bytes/2**30:.1f}GiB > "
                       f"cap {mem_cap/2**30:.1f}GiB"))
        else:
            ranked.append(proj)
    ranked.sort(key=lambda r: r.total_s)
    # keep only the best split per strategy in the headline ranking
    seen, dedup = set(), []
    for r in ranked:
        if r.strategy not in seen:
            dedup.append(r)
            seen.add(r.strategy)
    return Recommendation(dedup[0] if dedup else None, dedup, rejected)


@dataclass
class GroupChoice:
    """Per-layer-group winner in a strategy mixture (advisory)."""

    kind: str            # layer_stats kind: conv | fc | attn | ffn | moe | …
    n_layers: int
    strategy: str
    p1: int
    p2: int
    p2r: int             # model-grid factorization (summa winners; 1×1 else)
    p2c: int
    total_s: float       # projected epoch seconds for THIS group alone


def advise_groups(stats: list[LayerStat], tm: TimeModel, cfg: OracleConfig,
                  p: int, mem_cap: float | None = None,
                  strategies=("data", "spatial", "filter", "channel",
                              "df", "ds", "ep", "summa"),
                  cluster=None) -> list[GroupChoice]:
    """Per-layer-group strategy mixture: sweep each group of same-kind
    layers separately and report its winner (Jia et al., arXiv 1802.04924:
    per-layer hidden-dimension splits beat any single global strategy).

    Advisory, not a deployable plan: the resharding collectives at group
    boundaries are not priced, so the mixture's summed time is a lower
    bound. A mixture that beats the global winner by more than the
    boundary-reshard cost is the signal to split the deployment. Pipeline
    is excluded — its schedule spans the whole stack, not one group."""
    groups: dict[str, list[LayerStat]] = {}
    for s in stats:
        groups.setdefault(s.kind, []).append(s)
    out = []
    for kind in sorted(groups):
        gstats = groups[kind]
        try:
            rec = advise(gstats, tm, cfg, p, mem_cap=mem_cap,
                         strategies=strategies, cluster=cluster)
        except ValueError:   # no strategy applies to this group alone
            continue
        b = rec.best
        if b is None:
            continue
        out.append(GroupChoice(kind, len(gstats), b.strategy, b.p1, b.p2,
                               b.p2r, b.p2c, b.total_s))
    return out


def breakdown_table(recs: list[Projection]) -> str:
    """Fig-3-style text table: per-iteration comp/comm per strategy."""
    lines = [f"{'strategy':10s} {'p1xp2':>9s} {'comp_ms':>9s} {'comm_ms':>9s} "
             f"{'total_ms':>9s} {'mem_GiB':>8s}"]
    for r in recs:
        it = r.per_iteration()
        lines.append(
            f"{r.strategy:10s} {r.p1:>4d}x{r.p2:<4d} {it['comp_s']*1e3:9.2f} "
            f"{it['comm_s']*1e3:9.2f} {it['total_s']*1e3:9.2f} "
            f"{r.mem_bytes/2**30:8.2f}")
    return "\n".join(lines)
