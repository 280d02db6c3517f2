"""Vectorized oracle sweep engine (DESIGN.md §2); the port's copy of
``repro.core.sweep``.

Evaluates the Table-3 analytical model over an entire
``strategy × p-grid × (p1·p2 factorization)`` lattice in one shot, as numpy
array operations over the precomputed ``StatTable`` — instead of thousands
of scalar ``project()`` calls. The math is the SAME broadcastable evaluator
(oracle._eval) the per-point path uses, so vectorized and scalar results
agree to machine precision.

On top of the raw lattice, ``SweepResult`` provides:
  * per-point feasibility + bottleneck classification (comp-bound, GE-bound,
    FB-bound, halo-bound, p2p-bound, scale-/memory-infeasible),
  * best-split reduction per (strategy, p),
  * Pareto-frontier extraction over (p, time),
  * crossover points — at which p does strategy B overtake strategy A?

CLI (Fig-5-style scaling table):

    PYTHONPATH=src python -m repro_torch.core.sweep --model resnet50 --p 1..1024
    PYTHONPATH=src python -m repro_torch.core.sweep --model cosmoflow \
        --p 4..1024 --batch-per-pe 0.25 --crossover spatial ds
    PYTHONPATH=src python -m repro_torch.core.sweep --smoke

``--model`` takes the CNNs and any LM the port's ``configs`` register.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, replace

import numpy as np

from ..cluster import ClusterSpec, add_cluster_args
from ..hardware import PAPER_V100_CLUSTER
from ..oracle import (OracleConfig, PIPELINE_SCHEDULES, Projection,
                     STRATEGY_NAMES, StatTable, TimeModel, _eval, _limit_str,
                     precompute)

PURE_STRATEGIES = ("serial", "data", "spatial", "pipeline", "filter",
                   "channel")
HYBRID_STRATEGIES = ("df", "ds", "ep")
# strategies whose model width additionally factors into a (p2r × p2c)
# grid — an extra lattice axis on top of the p1·p2 factorization
GRID_STRATEGIES = ("summa",)

# memory-model switches swept as extra lattice axes (DESIGN.md §3/§8)
SWITCH_NAMES = ("remat", "zero1", "zero3", "seq_parallel")

_BOTTLENECK_OF_TERM = np.array(["comp-bound", "GE-bound", "FB-bound",
                                "halo-bound", "p2p-bound"])


def all_switch_combos() -> list[tuple[bool, bool, bool, bool]]:
    """All 16 (remat, zero1, zero3, seq_parallel) combinations."""
    import itertools
    return list(itertools.product((False, True), repeat=len(SWITCH_NAMES)))


def switch_label(remat: bool, zero1: bool, zero3: bool,
                 seq_parallel: bool) -> str:
    on = [n for n, v in zip(SWITCH_NAMES, (remat, zero1, zero3, seq_parallel))
          if v]
    return "+".join(on) if on else "-"


def factor_pairs(p: int) -> list[tuple[int, int]]:
    """ALL (p1, p2) with p1·p2 = p — exhaustive divisors, not just pow2."""
    out = []
    d = 1
    while d * d <= p:
        if p % d == 0:
            out.append((d, p // d))
            if d != p // d:
                out.append((p // d, d))
        d += 1
    return sorted(out)


def parse_p_grid(spec: str) -> list[int]:
    """'1..1024' → powers of two in range; '1..64:8' → arithmetic step;
    '4,6,12' → explicit list."""
    ps: list[int] = []
    for part in spec.split(","):
        part = part.strip()
        if ".." in part:
            rng, _, step = part.partition(":")
            lo, hi = (int(v) for v in rng.split(".."))
            if step:
                ps.extend(range(lo, hi + 1, int(step)))
            else:
                q = 1
                while q < lo:
                    q *= 2
                while q <= hi:
                    ps.append(q)
                    q *= 2
        elif part:
            ps.append(int(part))
    return sorted(set(ps))


@dataclass(eq=False)
class SweepResult:
    """Columnar table over the evaluated lattice (one row = one point)."""

    strategy: np.ndarray         # str
    p: np.ndarray                # int
    p1: np.ndarray               # int
    p2: np.ndarray               # int
    B: np.ndarray                # int (per-point global batch; weak scaling)
    iterations: np.ndarray
    comp_s: np.ndarray           # per-epoch seconds, as in Projection
    comm_ge_s: np.ndarray
    comm_fb_s: np.ndarray
    comm_halo_s: np.ndarray
    comm_p2p_s: np.ndarray
    mem_bytes: np.ndarray
    feasible: np.ndarray         # bool — scaling limits hold
    fits: np.ndarray             # bool — memory <= cap (True when no cap)
    bottleneck: np.ndarray       # str classification per point
    limit: np.ndarray            # str scaling-limit description per point
    # memory-model switch axes (DESIGN.md §3); constant columns unless the
    # sweep was asked to enumerate switch combos
    remat: np.ndarray = None     # bool
    zero1: np.ndarray = None     # bool
    zero3: np.ndarray = None     # bool
    seq_parallel: np.ndarray = None  # bool
    # pipeline schedule axis (DESIGN.md §4): the schedule each pipeline row
    # was priced under ("-" for non-pipeline rows)
    schedule: np.ndarray = None  # str
    # model-grid factorization axes (GRID_STRATEGIES, DESIGN.md §14):
    # p2 = p2r·p2c on summa rows, 1·1 everywhere else
    p2r: np.ndarray = None       # int
    p2c: np.ndarray = None       # int
    mem_cap: float | None = None

    def __post_init__(self):
        n = len(self.p)
        for name in SWITCH_NAMES:
            if getattr(self, name) is None:
                setattr(self, name, np.zeros(n, bool))
        if self.schedule is None:
            self.schedule = np.full(n, "-", dtype="U12")
        if self.p2r is None:
            self.p2r = np.ones(n, np.int64)
        if self.p2c is None:
            self.p2c = np.ones(n, np.int64)

    def __len__(self) -> int:
        return len(self.p)

    @property
    def n_switches(self) -> np.ndarray:
        """How many memory-model switches are on at each point."""
        return (self.remat.astype(int) + self.zero1.astype(int)
                + self.zero3.astype(int) + self.seq_parallel.astype(int))

    def switch_str(self, i: int) -> str:
        return switch_label(bool(self.remat[i]), bool(self.zero1[i]),
                            bool(self.zero3[i]), bool(self.seq_parallel[i]))

    @property
    def comm_s(self) -> np.ndarray:
        return (self.comm_ge_s + self.comm_fb_s + self.comm_halo_s
                + self.comm_p2p_s)

    @property
    def total_s(self) -> np.ndarray:
        return self.comp_s + self.comm_s

    @property
    def ok(self) -> np.ndarray:
        """Deployable points: scaling-feasible AND under the memory cap."""
        return self.feasible & self.fits

    # -- reductions ---------------------------------------------------------

    def select(self, mask_or_idx) -> "SweepResult":
        i = np.asarray(mask_or_idx)
        return replace(
            self, strategy=self.strategy[i], p=self.p[i], p1=self.p1[i],
            p2=self.p2[i], B=self.B[i], iterations=self.iterations[i],
            comp_s=self.comp_s[i], comm_ge_s=self.comm_ge_s[i],
            comm_fb_s=self.comm_fb_s[i], comm_halo_s=self.comm_halo_s[i],
            comm_p2p_s=self.comm_p2p_s[i], mem_bytes=self.mem_bytes[i],
            feasible=self.feasible[i], fits=self.fits[i],
            bottleneck=self.bottleneck[i], limit=self.limit[i],
            remat=self.remat[i], zero1=self.zero1[i], zero3=self.zero3[i],
            seq_parallel=self.seq_parallel[i], schedule=self.schedule[i],
            p2r=self.p2r[i], p2c=self.p2c[i])

    def for_strategy(self, strategy: str) -> "SweepResult":
        return self.select(self.strategy == strategy)

    def best_per_p(self, strategy: str | None = None,
                   require_ok: bool = True) -> "SweepResult":
        """Fastest point per (strategy, p) — the best p1·p2 split. With
        ``require_ok=False``, infeasible points are kept as fallbacks but a
        deployable split always wins over a faster infeasible one. With
        ``strategy`` given, one row per p for that strategy only."""
        total = self.total_s
        keep = self.ok if require_ok else np.ones(len(self), bool)
        if strategy is not None:
            keep &= self.strategy == strategy
        rank = {}
        for i in np.flatnonzero(keep):
            k = (self.strategy[i], int(self.p[i]))
            r = (not self.ok[i], total[i])
            if k not in rank or r < rank[k][0]:
                rank[k] = (r, i)
        idx = np.array(sorted((i for _, i in rank.values()),
                              key=lambda i: (self.strategy[i], self.p[i])),
                       dtype=int)
        return self.select(idx if idx.size else np.zeros(0, int))

    def pareto(self) -> "SweepResult":
        """Non-dominated deployable points over (p ↓, total_s ↓): a point
        survives iff no other point is at most as big AND at most as slow."""
        cand = self.best_per_p()
        order = np.lexsort((cand.total_s, cand.p))
        idx, best_t = [], np.inf
        for i in order:
            if cand.total_s[i] < best_t:
                idx.append(i)
                best_t = cand.total_s[i]
        return cand.select(np.array(idx, int))

    def crossover(self, base: str, challenger: str) -> int | None:
        """Smallest p in the grid where ``challenger``'s best split is
        strictly faster than ``base``'s (e.g. where df overtakes data)."""
        a = self.best_per_p(base)
        b = self.best_per_p(challenger)
        ta = {int(p): t for p, t in zip(a.p, a.total_s)}
        for p, t in sorted(zip(b.p, b.total_s)):
            if int(p) in ta and t < ta[int(p)]:
                return int(p)
        return None

    # -- interop / rendering ------------------------------------------------

    def to_projections(self) -> list[Projection]:
        """Rows as per-point ``Projection`` objects (advisor compatibility)."""
        return [Projection(str(self.strategy[i]), int(self.p[i]),
                           int(self.p1[i]), int(self.p2[i]),
                           float(self.comp_s[i]), float(self.comm_ge_s[i]),
                           float(self.comm_fb_s[i]), float(self.comm_halo_s[i]),
                           float(self.comm_p2p_s[i]), float(self.mem_bytes[i]),
                           bool(self.feasible[i]), str(self.limit[i]),
                           float(self.iterations[i]),
                           p2r=int(self.p2r[i]), p2c=int(self.p2c[i]))
                for i in range(len(self))]

    def table(self) -> str:
        """Fig-5-style text table: best split per (p, strategy), with the
        per-iteration breakdown and bottleneck classification."""
        best = self.best_per_p(require_ok=False)
        lines = [f"{'p':>6s} {'strategy':10s} {'p1xp2':>11s} {'B':>7s} "
                 f"{'comp_ms':>10s} {'comm_ms':>10s} {'total_ms':>10s} "
                 f"{'mem_GiB':>8s}  {'bottleneck':18s} {'limit'}"]
        short = {"gpipe": "gpipe", "one_f_one_b": "1f1b",
                 "interleaved": "ileav"}
        for p in sorted(set(int(v) for v in best.p)):
            sub = best.select(best.p == p)
            for i in np.argsort(np.where(sub.ok, sub.total_s, np.inf)):
                it = max(float(sub.iterations[i]), 1.0)
                mark = " " if sub.ok[i] else "!"
                sched = str(sub.schedule[i])
                disp = (f"pipe:{short.get(sched, sched)}"
                        if sched != "-" else str(sub.strategy[i]))
                if str(sub.strategy[i]) in GRID_STRATEGIES:
                    disp = f"{disp}:{int(sub.p2r[i])}x{int(sub.p2c[i])}"
                lines.append(
                    f"{p:>6d} {disp:10s} "
                    f"{int(sub.p1[i]):>5d}x{int(sub.p2[i]):<5d} "
                    f"{int(sub.B[i]):>7d} "
                    f"{float(sub.comp_s[i])/it*1e3:>10.3f} "
                    f"{float(sub.comm_s[i])/it*1e3:>10.3f} "
                    f"{float(sub.total_s[i])/it*1e3:>10.3f} "
                    f"{float(sub.mem_bytes[i])/2**30:>8.2f} {mark} "
                    f"{sub.bottleneck[i]:18s} {sub.limit[i]}")
        return "\n".join(lines)


def _lattice(strategy: str, p_grid, batch_of) -> tuple | None:
    """(p, p1, p2, p2r, p2c, B) integer arrays for one strategy's slice of
    the lattice. The grid axes are 1 except for GRID_STRATEGIES, which fan
    each (p1, p2) split over every (p2r, p2c) factorization of p2."""
    if strategy == "serial":
        pts = [(1, 1, 1, 1, 1)] if 1 in p_grid else []
    elif strategy == "data":
        pts = [(p, p, 1, 1, 1) for p in p_grid]
    elif strategy in PURE_STRATEGIES:
        pts = [(p, 1, p, 1, 1) for p in p_grid]
    elif strategy in GRID_STRATEGIES:
        pts = [(p, a, b, r, c) for p in p_grid for a, b in factor_pairs(p)
               for r, c in factor_pairs(b)]
    else:
        pts = [(p, a, b, 1, 1) for p in p_grid for a, b in factor_pairs(p)]
    if not pts:
        return None
    arr = np.array(pts, np.int64)
    B = np.array([batch_of(int(p)) for p in arr[:, 0]], np.int64)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4], B


def sweep(stats, tm: TimeModel, cfg: OracleConfig, p_grid,
          strategies=STRATEGY_NAMES, *, batch_for_p=None,
          mem_cap: float | None = None, switches=None, schedules=None,
          cluster: "ClusterSpec | None" = None) -> SweepResult:
    """Evaluate the whole (strategy × p × p1·p2 [× switches] [× schedules])
    lattice vectorized.

    ``batch_for_p``: optional callable p → global batch B (weak scaling);
    defaults to the constant ``cfg.B``. ``mem_cap``: per-PE bytes; points
    over it are classified memory-infeasible (but still reported).
    ``switches``: memory-model switch axes (DESIGN.md §3) — ``None``
    evaluates only the combination already set on ``cfg``; ``"all"``
    enumerates all 16 (remat, zero1, zero3, seq_parallel) combinations as a
    16× lattice axis; or pass an explicit iterable of 4-bool tuples.
    ``schedules``: the pipeline strategy's schedule axis (DESIGN.md §4) —
    ``None`` prices pipeline rows only under ``cfg.schedule`` (current
    behavior), ``"all"`` enumerates every executor schedule as extra
    pipeline rows, or pass an explicit iterable of schedule names.
    Non-pipeline strategies are schedule-invariant and carry ``"-"``.
    ``cluster``: a ClusterSpec whose torus topology (if any) additionally
    prunes lattice points whose model axis cannot embed as a physical ring
    (cluster.Torus.split_mask; DESIGN.md §11) — the α–β terms themselves
    still come from ``tm``/``cfg``, so a cluster with ``topology=None``
    changes nothing.
    """
    unknown = set(strategies) - set(STRATEGY_NAMES)
    if unknown:
        raise ValueError(f"unknown strategies {sorted(unknown)}; "
                         f"known: {list(STRATEGY_NAMES)}")
    if switches is None:
        combos = [(cfg.remat, cfg.zero1, cfg.zero3, cfg.seq_parallel)]
    elif switches == "all":
        combos = all_switch_combos()
    else:
        combos = [tuple(bool(v) for v in c) for c in switches]
        if any(len(c) != len(SWITCH_NAMES) for c in combos):
            raise ValueError(f"each switch combo must be a 4-tuple over "
                             f"{SWITCH_NAMES}")
    if schedules is None:
        scheds = (cfg.schedule,)
    elif schedules == "all":
        scheds = PIPELINE_SCHEDULES
    else:
        scheds = tuple(schedules)
        unknown = set(scheds) - set(PIPELINE_SCHEDULES)
        if unknown:
            raise ValueError(f"unknown schedules {sorted(unknown)}; "
                             f"known: {list(PIPELINE_SCHEDULES)}")
    T = precompute(stats, tm)
    p_grid = sorted(set(int(p) for p in p_grid if int(p) >= 1))
    batch_of = batch_for_p or (lambda p: cfg.B)
    cols: dict[str, list] = {k: [] for k in
                             ("strategy", "p", "p1", "p2", "p2r", "p2c",
                              "B", "iters",
                              "comp", "ge", "fb", "halo", "p2p", "mem",
                              "feasible", "limit", "schedule",
                              "remat", "zero1", "zero3", "seq_parallel")}
    for s in strategies:
        lat = _lattice(s, p_grid, batch_of)
        if lat is None:
            continue
        p, p1, p2, p2r, p2c, B = lat
        # the model width the seq-parallel switch shards the residual over:
        # the hybrids' p2, the full p for the pure model splits, and the
        # COLUMN ring for grid strategies (rows already shard the sequence)
        if s in GRID_STRATEGIES:
            p2_eff = p2c
        elif s in HYBRID_STRATEGIES:
            p2_eff = p2
        elif s in ("filter", "channel", "spatial"):
            p2_eff = p
        else:
            p2_eff = np.ones_like(p)
        # only the pipeline strategy has a schedule axis
        for sched in (scheds if s == "pipeline" else ("-",)):
            cfg_s = cfg if sched == "-" else replace(cfg, schedule=sched)
            # the lattice, feasibility and limit strings are switch-
            # invariant (scaling limits never involve the memory model) —
            # build them once per (strategy, schedule), re-evaluate only
            # the time/memory terms per combo
            evals = []
            for combo in combos:
                cfg_c = replace(cfg_s, **dict(zip(SWITCH_NAMES, combo)))
                try:
                    r = _eval(T, s, cfg_c, tm.system, p, p1, p2, p2_eff, B,
                              p2r=p2r, p2c=p2c)
                except ValueError:  # strategy inapplicable to this layer
                    break           # set, independent of the switch combo
                evals.append((combo, r))
            if not evals:
                continue
            n = len(p)
            bcast = (lambda v: np.broadcast_to(np.asarray(v, np.float64),
                                               (n,)).copy())
            feas = np.broadcast_to(np.asarray(evals[0][1]["feasible"], bool),
                                   (n,)).copy()
            topo = None if cluster is None else cluster.topology
            topo_ok = None
            if topo is not None:
                topo_ok = np.broadcast_to(
                    topo.split_mask(p, p1, p2, strategy=s, p2r=p2r, p2c=p2c),
                    (n,)).copy()
                feas &= topo_ok
            memo: dict = {}   # limit strings only vary with (B, feasible)

            def limit_of(Bi: int, fi: bool) -> str:
                k = (Bi, fi)
                if k not in memo:
                    memo[k] = _limit_str(s, T, Bi, fi, cfg_s)
                return memo[k]

            limits = np.array(
                [limit_of(int(Bi), bool(fi)) for Bi, fi in zip(B, feas)],
                dtype=object)
            if topo_ok is not None and not topo_ok.all():
                # topology-pruned points carry the placement reason, not
                # the (possibly satisfied) scaling limit
                limits = np.where(topo_ok, limits,
                                  topo.limit_str(s)).astype(object)
            sched_label = cfg.schedule if s == "pipeline" and sched == "-" \
                else sched
            for combo, r in evals:
                cols["strategy"].append(np.full(n, s, dtype="U8"))
                cols["p"].append(p)
                cols["p1"].append(p1)
                cols["p2"].append(p2)
                cols["p2r"].append(p2r)
                cols["p2c"].append(p2c)
                cols["B"].append(B)
                cols["iters"].append(bcast(r["iters"]))
                for k in ("comp", "ge", "fb", "halo", "p2p", "mem"):
                    cols[k].append(bcast(r[k]))
                for name, v in zip(SWITCH_NAMES, combo):
                    cols[name].append(np.full(n, bool(v)))
                cols["schedule"].append(np.full(n, sched_label, dtype="U12"))
                cols["feasible"].append(feas)
                cols["limit"].append(limits)
    if not cols["p"]:
        e = np.zeros(0)
        z = np.zeros(0, bool)
        return SweepResult(
            strategy=np.zeros(0, "U8"), p=np.zeros(0, int),
            p1=np.zeros(0, int), p2=np.zeros(0, int), B=np.zeros(0, int),
            iterations=e, comp_s=e, comm_ge_s=e, comm_fb_s=e, comm_halo_s=e,
            comm_p2p_s=e, mem_bytes=e, feasible=z, fits=z,
            bottleneck=np.zeros(0, object), limit=np.zeros(0, object),
            remat=z, zero1=z, zero3=z, seq_parallel=z,
            schedule=np.zeros(0, "U12"), p2r=np.zeros(0, int),
            p2c=np.zeros(0, int), mem_cap=mem_cap)
    cat = {k: np.concatenate(v) for k, v in cols.items()}
    fits = (cat["mem"] <= mem_cap if mem_cap is not None
            else np.ones(len(cat["p"]), bool))
    terms = np.stack([cat["comp"], cat["ge"], cat["fb"], cat["halo"],
                      cat["p2p"]])
    bottleneck = _BOTTLENECK_OF_TERM[np.argmax(terms, axis=0)].astype(object)
    bottleneck[~fits] = "memory-infeasible"
    bottleneck[~cat["feasible"]] = "scale-infeasible"
    return SweepResult(
        strategy=cat["strategy"], p=cat["p"], p1=cat["p1"], p2=cat["p2"],
        B=cat["B"], iterations=cat["iters"], comp_s=cat["comp"],
        comm_ge_s=cat["ge"], comm_fb_s=cat["fb"], comm_halo_s=cat["halo"],
        comm_p2p_s=cat["p2p"], mem_bytes=cat["mem"],
        feasible=cat["feasible"], fits=fits, bottleneck=bottleneck,
        limit=cat["limit"], remat=cat["remat"], zero1=cat["zero1"],
        zero3=cat["zero3"], seq_parallel=cat["seq_parallel"],
        schedule=cat["schedule"], p2r=cat["p2r"], p2c=cat["p2c"],
        mem_cap=mem_cap)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

_CNN_DATASETS = {"resnet50": 1_281_167, "vgg16": 1_281_167,
                 "cosmoflow": 1584}


def _model_config(name: str):
    """The model config object behind a CLI --model name."""
    from ...models.cnn import RESNET50, CosmoFlowConfig, VGGConfig
    cnn = {"resnet50": RESNET50, "vgg16": VGGConfig(),
           "cosmoflow": CosmoFlowConfig(img=128)}
    if name in cnn:
        return cnn[name]
    from ...configs import get_config
    return get_config(name).model


def _model_stats(name: str, seq: int):
    from ..layer_stats import stats_for
    mc = _model_config(name)
    if name in _CNN_DATASETS:
        return stats_for(mc), _CNN_DATASETS[name]
    return stats_for(mc, seq), 100_000


def _smoke() -> int:
    """Tiny self-check for CI: lattice vs scalar project() parity."""
    from ..oracle import project
    from ...models.cnn import RESNET50
    from ..layer_stats import stats_for
    stats = stats_for(RESNET50)
    tm = TimeModel(PAPER_V100_CLUSTER)
    cfg = OracleConfig(B=64, D=6400)
    res = sweep(stats, tm, cfg, [1, 2, 4, 8, 12, 16], mem_cap=16e9,
                schedules="all")
    worst = 0.0
    for i in range(len(res)):
        sched = str(res.schedule[i])
        cfg_i = cfg if sched == "-" else replace(cfg, schedule=sched)
        pr = project(str(res.strategy[i]), stats, tm, cfg_i, int(res.p[i]),
                     p1=int(res.p1[i]), p2=int(res.p2[i]),
                     p2r=int(res.p2r[i]), p2c=int(res.p2c[i]))
        ref = pr.total_s
        worst = max(worst, abs(res.total_s[i] - ref) / max(abs(ref), 1e-30))
    assert worst < 1e-9, f"sweep/scalar mismatch: {worst:.2e}"
    assert res.crossover("data", "df") is None or res.crossover("data", "df") > 0
    n_sched = len(set(str(s) for s in
                      res.select(res.strategy == "pipeline").schedule))
    assert n_sched == len(PIPELINE_SCHEDULES), \
        f"expected {len(PIPELINE_SCHEDULES)} pipeline schedules, got {n_sched}"
    print(f"sweep --smoke OK: {len(res)} lattice points "
          f"({n_sched} pipeline schedules), "
          f"max rel err vs project() = {worst:.2e}")
    return 0


def _resolve_strategies(names) -> tuple:
    """Map CLI --strategies names onto oracle strategy names.

    Accepts both the oracle spellings (STRATEGY_NAMES) and the executable
    rules-table spellings (``parallel.strategies.list_strategies()``, e.g.
    ``df_zero3`` → ``df`` via ``autotune.ORACLE_OF_EXEC``), in order,
    without repeats. Unknown names raise with BOTH valid sets, so a typo
    cannot price an empty or partial lattice. The executable namespace is
    imported here, not at the top: ``core.autotune`` imports this module.
    """
    exec_names: tuple = ()
    oracle_of_exec: dict = {}
    if any(n not in STRATEGY_NAMES for n in names):
        from ..autotune import ORACLE_OF_EXEC as oracle_of_exec
        from ...parallel.strategies import list_strategies
        exec_names = tuple(list_strategies())
    out, unknown = [], []
    for n in names:
        if n in STRATEGY_NAMES:
            out.append(n)
        elif n in oracle_of_exec:
            out.append(oracle_of_exec[n])
        else:
            unknown.append(n)
    if unknown:
        valid = sorted(set(STRATEGY_NAMES) | set(exec_names))
        raise ValueError(
            f"unknown strategy name(s) {unknown}; valid names: {valid}")
    seen: set = set()
    return tuple(n for n in out if not (n in seen or seen.add(n)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.sweep",
        description="Vectorized oracle sweep: Fig-5-style strategy × scale "
                    "table from the Table-3 analytical model.")
    ap.add_argument("--model", default="resnet50",
                    help="resnet50 | vgg16 | cosmoflow | any configs/ LM name")
    ap.add_argument("--p", default="1..1024",
                    help="p grid: '1..1024' (pow2), '4..64:4' (step), '4,6,12'")
    ap.add_argument("--batch", type=int, default=None,
                    help="fixed global batch B (default: weak scaling)")
    ap.add_argument("--batch-per-pe", type=float, default=2.0,
                    help="weak scaling: B = max(round(b·p), 1)")
    ap.add_argument("--dataset", type=int, default=None,
                    help="samples per epoch D (default: per-model)")
    ap.add_argument("--seq", type=int, default=4096, help="LM sequence length")
    ap.add_argument("--mem-cap-gib", type=float, default=None,
                    help="per-PE memory cap (default: system capacity)")
    for flag in ("remat", "zero1", "zero3", "seq-parallel"):
        ap.add_argument(f"--{flag}", action="store_true",
                        help=f"memory-model switch (DESIGN.md §3)")
    add_cluster_args(ap, default_system="paper")
    ap.add_argument("--no-overlap", action="store_true",
                    help="charge every comm term serially — the paper's "
                         "original accounting (default: halo P2P and the "
                         "gradient exchange hide under compute, DESIGN.md "
                         "§10)")
    ap.add_argument("--strategies", default=",".join(STRATEGY_NAMES),
                    help="comma-separated strategy subset; oracle names "
                         f"({'/'.join(STRATEGY_NAMES)}) or executable "
                         "rules-table names (parallel/strategies.py); "
                         "unknown names are rejected with the valid set")
    ap.add_argument("--schedule", default="all",
                    help="pipeline schedule axis: 'all' (default) sweeps "
                         f"{'/'.join(PIPELINE_SCHEDULES)} as extra pipeline "
                         "rows, or name one")
    ap.add_argument("--virtual-stages", type=int, default=2,
                    help="v for the interleaved schedule (chunks per rank)")
    ap.add_argument("--crossover", nargs=2, metavar=("BASE", "CHALLENGER"),
                    default=("data", "df"),
                    help="report smallest p where CHALLENGER beats BASE")
    ap.add_argument("--csv", action="store_true", help="raw per-point CSV")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny self-check sweep (CI gate)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke()

    stats, default_D = _model_stats(args.model, args.seq)
    cluster = ClusterSpec.from_cli_args(args)
    tm = TimeModel(cluster.system)
    p_grid = parse_p_grid(args.p)
    D = args.dataset or default_D
    if args.batch is not None:
        batch_of = lambda p: args.batch          # noqa: E731
    else:
        batch_of = lambda p: max(int(round(args.batch_per_pe * p)), 1)  # noqa: E731
    cfg = cluster.oracle_config(
        B=batch_of(max(p_grid)), D=max(D, batch_of(max(p_grid))),
        remat=args.remat, zero1=args.zero1, zero3=args.zero3,
        seq_parallel=args.seq_parallel, overlap=not args.no_overlap,
        virtual_stages=max(args.virtual_stages, 1))
    cap = (args.mem_cap_gib * 2 ** 30 if args.mem_cap_gib
           else tm.system.mem_capacity)
    try:
        strategies = _resolve_strategies(
            tuple(s for s in args.strategies.split(",") if s))
    except ValueError as e:
        ap.error(str(e))
    res = sweep(stats, tm, cfg, p_grid, strategies, batch_for_p=batch_of,
                mem_cap=cap, cluster=cluster,
                schedules="all" if args.schedule == "all" else (args.schedule,))

    if args.csv:
        print("strategy,schedule,p,p1,p2,B,comp_s,comm_ge_s,comm_fb_s,"
              "comm_halo_s,comm_p2p_s,mem_bytes,feasible,fits,bottleneck")
        for i in range(len(res)):
            print(f"{res.strategy[i]},{res.schedule[i]},"
                  f"{res.p[i]},{res.p1[i]},{res.p2[i]},"
                  f"{res.B[i]},{res.comp_s[i]:.9g},{res.comm_ge_s[i]:.9g},"
                  f"{res.comm_fb_s[i]:.9g},{res.comm_halo_s[i]:.9g},"
                  f"{res.comm_p2p_s[i]:.9g},{res.mem_bytes[i]:.9g},"
                  f"{int(res.feasible[i])},{int(res.fits[i])},"
                  f"{res.bottleneck[i]}")
        return 0

    print(f"# model={args.model} system={tm.system.name} "
          f"D={cfg.D} mem_cap={cap/2**30:.1f}GiB "
          f"B={'fixed %d' % args.batch if args.batch else 'weak %.3g/PE' % args.batch_per_pe} "
          f"overlap={'off (serial comm, paper model)' if args.no_overlap else 'on'}")
    print(f"# lattice: {len(res)} points "
          f"({len(p_grid)} p-values × strategies × exhaustive p1·p2 splits); "
          f"'!' rows are infeasible at that p")
    print(res.table())
    base, chal = args.crossover
    x = res.crossover(base, chal)
    print(f"# crossover: {chal} overtakes {base} at p={x}" if x else
          f"# crossover: {chal} never overtakes {base} on this grid")
    front = res.pareto()
    if len(front):
        pts = ", ".join(f"p={int(p)}:{s}({int(a)}x{int(b)})"
                        for p, s, a, b in zip(front.p, front.strategy,
                                              front.p1, front.p2))
        print(f"# pareto frontier (p vs time): {pts}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
