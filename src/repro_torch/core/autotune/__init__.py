"""Oracle-in-the-loop auto-tuner (DESIGN.md §8); the port's copy of
``repro.core.autotune``.

The sweep engine (sweep/) computes the full strategy × p1·p2 × memory-switch
lattice; this module turns that into a *deployment decision*: given an
arch × shape × device count, pick the cheapest point that fits memory and
return it as a ``TunedPlan`` — strategy, mesh factorization, memory-model
switches, and the projected bottleneck. ``launch/train.py --strategy auto``
deploys the plan (``runtime.elastic.bind_plan`` shapes its mesh, and
``launch.build.build_cell`` assembles the cell), as ``launch/serve.py
--strategy auto`` and ``api.Oracle.build`` do, so the oracle is the
decision-maker, not just a report.

Ranking (cheapest-that-fits):
  1. drop points that violate a scaling limit or the per-PE memory cap;
  2. minimize projected step time;
  3. on ties (within ``rtol``): prefer the config's fallback strategy if it
     is among the tied winners, then the fewest memory switches on (each
     switch has unmodeled runtime overhead), then the narrowest model
     width p2, then name order — fully deterministic.
If nothing fits, the fallback strategy's least-memory point is returned
with ``feasible=False`` so callers can still proceed (and warn).

CLI — "what should I run on p GPUs?":

    PYTHONPATH=src python -m repro_torch.core.autotune --model resnet50 --p 64
    PYTHONPATH=src python -m repro_torch.core.autotune --model cosmoflow \
        --p 8,64,1024 --batch-per-pe 0.25
    PYTHONPATH=src python -m repro_torch.core.autotune --smoke
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np

from ..cluster import ClusterSpec, add_cluster_args
from ..hardware import TPU_V5E_POD
from ..oracle import OracleConfig, TimeModel
from ..sweep import (HYBRID_STRATEGIES, SweepResult, parse_p_grid,
                     switch_label, sweep)

# oracle strategies with an executable deployment path in the reference: a
# rules table in parallel/strategies.py, plus the stage schedules (gpipe /
# 1F1B / interleaved) for "pipeline" (parallel/schedules.
# make_pipeline_train_step; models the stage compiler cannot cut are
# filtered per-arch via ``allow_pipeline``). The port's trainer refuses,
# naming the queue item, the plans it cannot run yet: "summa" on a CNN or
# an SSM LM (item 8), "ep" (item 10).
DEPLOYABLE_STRATEGIES = ("serial", "data", "spatial", "filter", "channel",
                         "df", "ds", "ep", "summa", "pipeline")

# tie-break preference between equal-time strategies: fewest moving parts
# first (no collectives < gradient exchange only < hybrids < layer-wise
# collectives < expert all-to-alls < 2D grids < stage schedules)
_PREF = {s: i for i, s in enumerate(
    ("serial", "data", "ds", "df", "spatial", "filter", "channel", "ep",
     "summa", "pipeline"))}

# executable rules-table name → oracle strategy (for fallback tie-breaks on
# arch configs, whose ``strategy`` fields name rules tables)
ORACLE_OF_EXEC = {
    "data": "data", "spatial": "spatial", "filter": "filter",
    "channel": "channel", "df": "df", "df_zero1": "df", "df_zero3": "df",
    "ds": "ds", "ep_df": "ep", "serve_tp": "df", "serve_seqkv": "ds",
    "pipeline": "pipeline", "summa": "summa",
}


@dataclass(frozen=True)
class TunedPlan:
    """One deployment decision: what to run on p PEs and how."""

    strategy: str            # oracle strategy name (STRATEGY_NAMES)
    p: int
    p1: int                  # data-parallel groups
    p2: int                  # model-parallel width
    remat: bool
    zero1: bool
    zero3: bool
    seq_parallel: bool
    bottleneck: str          # sweep classification at the chosen point
    total_s: float           # projected per-epoch seconds
    iterations: float
    mem_bytes: float
    mem_cap: float | None
    feasible: bool           # False → fallback plan, nothing fit
    source: str              # "sweep" | "fallback"
    segments: int = 8        # microbatch count the projection assumed
                             # (pipeline plans; deploy must run the same S)
    schedule: str = "gpipe"  # pipeline schedule the projection priced
                             # (PIPELINE_SCHEDULES; deploy must run it)
    virtual_stages: int = 2  # v for interleaved plans (chunks per rank)
    p2r: int = 1             # model-grid rows (summa plans: p2 = p2r·p2c)
    p2c: int = 1             # model-grid cols
    kernel_tiles: object = None  # tuned kernel tiles riding with the plan;
                             # always None here: ``autotune`` never sets it
                             # (the Hopper kernel tuner is ROADMAP queue 1
                             # item 11)

    @property
    def switches(self) -> dict:
        return {"remat": self.remat, "zero1": self.zero1,
                "zero3": self.zero3, "seq_parallel": self.seq_parallel}

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """(data, model) mesh factorization to deploy."""
        return (self.p1, self.p2)

    def mesh_spec(self) -> tuple[tuple[int, ...], tuple[str, ...]]:
        """(shape, axis names) of the mesh this plan deploys on — summa
        plans need the factored (data, model_r, model_c) grid mesh."""
        if self.strategy == "summa":
            return ((self.p1, self.p2r, self.p2c),
                    ("data", "model_r", "model_c"))
        return ((self.p1, self.p2), ("data", "model"))

    @property
    def per_iter_s(self) -> float:
        return self.total_s / max(self.iterations, 1.0)

    @property
    def n_switches_on(self) -> int:
        return sum(self.switches.values())

    def switch_str(self) -> str:
        return switch_label(self.remat, self.zero1, self.zero3,
                            self.seq_parallel)

    def exec_strategy(self, kind: str = "train") -> str:
        """The executable rules-table name (parallel/strategies.py) that
        deploys this plan for a train / prefill / decode cell."""
        if kind in ("prefill", "decode"):
            # serving: no ZeRO (latency-critical); expert plans keep ep rules.
            # pipeline plans also serve as TP — every pipeline schedule
            # (gpipe / 1F1B / interleaved) is a TRAINING schedule (fill/
            # drain over microbatches).
            return "ep_df" if self.strategy == "ep" else "serve_tp"
        table = {"serial": "data", "data": "data", "spatial": "ds",
                 "filter": "filter", "channel": "channel", "ds": "ds",
                 "ep": "ep_df", "pipeline": "pipeline", "summa": "summa"}
        if self.strategy == "df":
            if self.zero3:
                return "df_zero3"
            return "df_zero1" if self.zero1 else "df"
        return table[self.strategy]

    def describe(self) -> str:
        cap = (f"{self.mem_cap / 2**30:.1f}" if self.mem_cap else "∞")
        strat = (f"{self.strategy}:{self.schedule}"
                 if self.strategy == "pipeline" else self.strategy)
        if self.strategy == "summa":
            strat = f"summa:{self.p2r}x{self.p2c}"
        tiles = ""
        if self.kernel_tiles is not None and len(self.kernel_tiles):
            tiles = f", {len(self.kernel_tiles)} tuned kernel tiles"
        return (f"TunedPlan[p={self.p}]: {strat} "
                f"(mesh {self.p1}x{self.p2}, switches {self.switch_str()}) "
                f"→ {self.per_iter_s * 1e3:.2f} ms/iter, "
                f"{self.mem_bytes / 2**30:.2f}/{cap} GiB, "
                f"{self.bottleneck}{tiles}"
                + ("" if self.feasible else "  [FALLBACK: nothing fits]"))


def _plan_of(res: SweepResult, i: int, mem_cap, feasible: bool,
             source: str, segments: int = 8,
             virtual_stages: int = 2) -> TunedPlan:
    sched = str(res.schedule[i])
    return TunedPlan(
        strategy=str(res.strategy[i]), p=int(res.p[i]), p1=int(res.p1[i]),
        p2=int(res.p2[i]), remat=bool(res.remat[i]), zero1=bool(res.zero1[i]),
        zero3=bool(res.zero3[i]), seq_parallel=bool(res.seq_parallel[i]),
        bottleneck=str(res.bottleneck[i]), total_s=float(res.total_s[i]),
        iterations=float(res.iterations[i]),
        mem_bytes=float(res.mem_bytes[i]), mem_cap=mem_cap,
        feasible=feasible, source=source, segments=segments,
        schedule="gpipe" if sched == "-" else sched,
        virtual_stages=virtual_stages,
        p2r=int(res.p2r[i]), p2c=int(res.p2c[i]))


def deployable_switch_mask(res: SweepResult, allow_remat: bool = True):
    """Which lattice points' switch combos the exec path can actually
    realize — a plan must never claim "fits" via a switch that
    ``exec_strategy``/``launch/train.py`` won't turn on:

    * ``zero1`` — deployable everywhere (``OptimizerConfig(zero1=...)`` +
      ``zero1_rules`` apply to any rules table);
    * ``zero3`` — only the ``df``/``ep`` rules tables shard params over the
      data axis (``df_zero3`` / ``ep_df``);
    * ``seq_parallel`` — only the model-axis tables (``df``/``filter``/
      ``channel``/``ep``) shard the residual stream; ``summa`` is excluded
      from both ZeRO-3 and the seq switch — its residual is already
      sequence-sharded over the grid rows, the extra column-axis pass the
      oracle prices has no exec path;
    * ``remat`` — wire-able only where the model's forward supports it
      (lm / vlm / encdec; CNN forwards have no checkpointing), gated by
      ``allow_remat``;
    * ``pipeline`` — the pipeline step (any schedule) deploys no memory
      switches (its projection is switch-invariant anyway), so only the
      all-off combo stands.
    """
    strat = res.strategy
    m = np.ones(len(res), bool)
    if not allow_remat:
        m &= ~res.remat
    m &= ~res.zero3 | np.isin(strat, ("df", "ep"))
    m &= ~res.seq_parallel | np.isin(strat, ("df", "filter", "channel", "ep"))
    m &= (strat != "pipeline") | (res.n_switches == 0)
    return m


def _segments_resolvable(batch: int, segments: int, multiple_of: int) -> bool:
    """Whether the executor's resolve_segments() would find a microbatch
    count (needed to gate interleaved plans: S must be a multiple of the
    stage count)."""
    import warnings
    from ...parallel.schedules.train_step import resolve_segments
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            resolve_segments(batch, segments, multiple_of=multiple_of)
        return True
    except ValueError:
        return False


def deployable_schedule_mask(res: SweepResult, cfg: OracleConfig,
                             max_stages: int | None = None):
    """Which lattice points' pipeline schedules the executor can actually
    realize. gpipe/1F1B deploy wherever pipeline itself does; interleaved
    additionally needs (a) ``v·p2`` chunks to fit the model's block stack
    and (b) a microbatch count S ≤ ``cfg.segments`` with B % S == 0 and
    S % p2 == 0 (the runtime resolves segments with
    ``multiple_of=n_stages`` and raises otherwise)."""
    m = np.ones(len(res), bool)
    il = np.asarray(res.schedule) == "interleaved"
    if not il.any():
        return m
    v = max(int(cfg.virtual_stages), 1)
    if max_stages is not None:
        m &= ~il | (v * res.p2 <= max_stages)
    for j in np.flatnonzero(il & m):
        if not _segments_resolvable(int(res.B[j]), int(cfg.segments),
                                    int(res.p2[j])):
            m[j] = False
    return m


def autotune(stats, tm: TimeModel, cfg: OracleConfig, p: int, *,
             mem_cap: float | None = None, strategies=None,
             switches="all", schedules="all", fallback: str | None = None,
             allow_remat: bool = True, allow_pipeline: bool = True,
             max_stages: int | None = None, model_width: int | None = None,
             model_widths: "tuple[int, ...] | None" = None,
             model_grid: "tuple[int, int] | None" = None,
             cluster: "ClusterSpec | None" = None,
             rtol: float = 1e-9) -> TunedPlan:
    """Pick the cheapest deployable (strategy, p1·p2, switches, schedule)
    point at p.

    ``fallback``: strategy name (oracle or executable-rules spelling) that
    wins ties and is returned when nothing fits. ``switches``: as in
    ``sweep()`` — default sweeps all 16 memory-switch combinations, then
    masks the ones the exec path cannot realize per strategy
    (``deployable_switch_mask``); ``schedules``: as in ``sweep()`` —
    default prices every pipeline schedule (gpipe / 1F1B / interleaved)
    and lets the cheapest deployable one win, then masks the ones the
    executor cannot realize (``deployable_schedule_mask``);
    ``allow_remat=False`` additionally bars remat (models whose forward
    cannot checkpoint), and ``allow_pipeline=False`` bars the pipeline
    strategy entirely (models the stage compiler cannot cut —
    ``parallel.schedules.pipeline_supported``).
    ``model_width`` constrains hybrid plans to one p2 — pass the mesh's
    model-axis size when the mesh is already shaped and cannot be
    refactorized (summa plans are excluded there: a 1D ("data", "model")
    mesh carries no (model_r, model_c) grid). ``model_widths`` is the
    allowed-SET form of the same constraint — pass the p2 values a mesh
    factory can realize (e.g. the divisors of the device count) to get
    the cheapest plan that tiles, instead of silently dropping the model
    axis when the single winner doesn't. ``model_grid`` is the
    converse: pass the (r, c) extents of an already-shaped grid mesh and
    only summa points on exactly that grid survive.
    ``cluster``: a ClusterSpec whose torus topology prunes
    p1·p2 factorizations the machine cannot physically host (model axis
    must ring within one allowed torus dim — cluster.Torus); pruned points
    are never deployed, they fall out of the lattice like any other
    infeasibility.
    """
    mem_cap = mem_cap if mem_cap is not None else tm.system.mem_capacity
    fallback = ORACLE_OF_EXEC.get(fallback, fallback)
    if strategies is None:
        strategies = tuple(
            s for s in DEPLOYABLE_STRATEGIES
            if (s != "serial" or p == 1)
            and (s != "pipeline" or allow_pipeline))
    elif not allow_pipeline:
        if "pipeline" in strategies and len(set(strategies)) == 1:
            raise ValueError(
                "pipeline was requested but this model cannot deploy it "
                "(no uniform block stack — parallel.schedules."
                "pipeline_supported)")
        strategies = tuple(s for s in strategies if s != "pipeline")
    res = sweep(stats, tm, cfg, [p], strategies, mem_cap=mem_cap,
                switches=switches, schedules=schedules, cluster=cluster)
    if len(res) == 0:
        raise ValueError(f"no strategy in {strategies} applies to this model")
    keep = deployable_switch_mask(res, allow_remat=allow_remat)
    if model_width is not None:
        # pure strategies ignore the hybrid split — except pipeline, whose
        # stage count IS its p2: it must land on the mesh's model width just
        # like the hybrids, or the deployed stage count won't match the plan
        keep &= (~np.isin(res.strategy, HYBRID_STRATEGIES + ("pipeline",))
                 | (res.p2 == model_width))
        keep &= res.strategy != "summa"
    if model_widths is not None:
        keep &= (~np.isin(res.strategy, HYBRID_STRATEGIES + ("pipeline",))
                 | np.isin(res.p2, tuple(model_widths)))
        keep &= res.strategy != "summa"
    if model_grid is not None:
        r, c = model_grid
        keep &= ((res.strategy == "summa") & (res.p2r == r)
                 & (res.p2c == c))
    if max_stages is not None:
        # the oracle's p <= G bound counts STAT layers; the executor cuts
        # the model's BLOCK stack, which is shorter (attn+ffn share a block)
        keep &= (res.strategy != "pipeline") | (res.p2 <= max_stages)
    keep &= deployable_schedule_mask(res, cfg, max_stages=max_stages)
    res = res.select(keep)
    if len(res) == 0:
        raise ValueError(
            f"every lattice point at p={p} was filtered out (switches="
            f"{switches!r}, allow_remat={allow_remat}, "
            f"model_width={model_width}); relax the constraints")
    nsw = res.n_switches
    ok = res.ok
    if ok.any():
        total = res.total_s
        tied = ok & (total <= total[ok].min() * (1.0 + rtol))
        if fallback is not None and np.any(tied & (res.strategy == fallback)):
            tied &= res.strategy == fallback
        i = min(np.flatnonzero(tied),
                key=lambda j: (int(nsw[j]), int(res.p2[j]),
                               _PREF.get(str(res.strategy[j]), 99),
                               int(res.p1[j])))
        return _plan_of(res, i, mem_cap, feasible=True, source="sweep",
                        segments=cfg.segments,
                        virtual_stages=cfg.virtual_stages)
    # nothing fits: fall back to the requested strategy's least-memory point
    cand = np.flatnonzero(res.strategy == fallback) if fallback else None
    if cand is None or cand.size == 0:
        cand = np.arange(len(res))
    i = min(cand, key=lambda j: (float(res.mem_bytes[j]), int(nsw[j]),
                                 int(res.p2[j]),
                                 _PREF.get(str(res.strategy[j]), 99)))
    return _plan_of(res, i, mem_cap, feasible=False, source="fallback",
                    segments=cfg.segments,
                    virtual_stages=cfg.virtual_stages)


# ---------------------------------------------------------------------------
# Launch-entry-point glue: arch registry → TunedPlan
# ---------------------------------------------------------------------------

def stats_for_model(mc, seq: int | None = None):
    """Per-layer oracle stats for any registered model config (CNN configs
    take no sequence length)."""
    from ...models.cnn import CosmoFlowConfig, ResNetConfig, VGGConfig
    from ..layer_stats import stats_for
    if isinstance(mc, (ResNetConfig, VGGConfig, CosmoFlowConfig)):
        return stats_for(mc)
    return stats_for(mc, seq or 4096)


def plan_for_arch(arch_cfg, shape_name, p: int, *,
                  system=None, cluster: "ClusterSpec | None" = None,
                  smoke: bool = False,
                  mem_cap: float | None = None, switches="all",
                  model_width: int | None = None,
                  model_grid: "tuple[int, int] | None" = None,
                  cfg: OracleConfig | None = None,
                  stats=None,
                  allow_pipeline: bool | None = None) -> TunedPlan:
    """Auto-tune a registered arch at one input shape (a ``SHAPES`` name or
    a ``ShapeSpec``) on p PEs.

    ``system`` (a SystemModel or a ClusterSpec) defaults to the TPU-v5e
    deployment target (projection mode); the oracle config is one epoch of
    exactly the shape's global batch, so the plan ranks per-iteration time
    (``cfg`` and ``stats`` override both — the session facade passes its
    own so tune() ranks exactly what project()/sweep() report).
    ``cluster`` supplies the machine description in one argument: α–β
    system, φ/σ tables, and the torus topology that prunes unrealizable
    p1·p2 factorizations. ``model_width``: see ``autotune``.
    ``allow_pipeline``: None (default) lets the model's block structure
    decide; False bars the pipeline strategy even where it is deployable —
    the reference's elastic controller passes False because its rebind
    path rebuilds a plain SPMD step, not a stage schedule.
    """
    from ...configs.base import SHAPES
    from ...parallel.schedules import pipeline_block_count, pipeline_supported
    if isinstance(system, ClusterSpec) and cluster is None:
        cluster = system
    cluster = ClusterSpec.coerce(cluster)
    if cluster is not None:
        system = cluster.system
    mc = arch_cfg.smoke_model if smoke else arch_cfg.model
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if stats is None:
        stats = stats_for_model(mc, shape.seq_len)
    tm = TimeModel(system or TPU_V5E_POD)
    if cfg is None:
        B = shape.global_batch
        cfg = (cluster.oracle_config(B=B, D=B) if cluster is not None
               else OracleConfig(B=B, D=B))
    can_pipe = (shape.kind == "train" and pipeline_supported(mc) is None
                and allow_pipeline is not False)
    return autotune(stats, tm, cfg, p, mem_cap=mem_cap, switches=switches,
                    fallback=arch_cfg.strategy_for(shape.name),
                    model_width=model_width, model_grid=model_grid,
                    cluster=cluster,
                    allow_remat=arch_cfg.family != "cnn",
                    allow_pipeline=can_pipe,
                    max_stages=pipeline_block_count(mc))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _smoke() -> int:
    """Self-check: the tuner's pick must be the sweep's cheapest ok point,
    and (with switches pinned to the config's) must agree with advise()."""
    from ...models.cnn import RESNET50
    from ..advisor import advise
    from ..hardware import PAPER_V100_CLUSTER
    from ..layer_stats import stats_for
    stats = stats_for(RESNET50)
    tm = TimeModel(PAPER_V100_CLUSTER)
    cfg = OracleConfig(B=128, D=12800)
    for p in (8, 64):
        plan = autotune(stats, tm, cfg, p)
        assert plan.feasible and plan.p1 * plan.p2 == p, plan
        res = sweep(stats, tm, cfg, [p], mem_cap=plan.mem_cap,
                    switches="all", schedules="all")
        dep = (res.ok & deployable_switch_mask(res)
               & deployable_schedule_mask(res, cfg))
        assert np.isclose(plan.total_s, res.total_s[dep].min(),
                          rtol=1e-12), (plan, res.total_s[dep].min())
        pinned = autotune(stats, tm, cfg, p, switches=None,
                          strategies=("data", "spatial", "filter", "channel",
                                      "df", "ds", "ep"))
        rec = advise(stats, tm, cfg, p, mem_cap=plan.mem_cap,
                     strategies=("data", "spatial", "filter", "channel",
                                 "df", "ds", "ep"))
        assert rec.best is not None
        assert np.isclose(pinned.total_s, rec.best.total_s, rtol=1e-12)
        print(f"autotune --smoke p={p}: {plan.describe()}")
    return 0


def main(argv=None) -> int:
    from ..sweep import _model_config, _model_stats
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.autotune",
        description="Oracle-in-the-loop auto-tuner: what should I run on "
                    "p PEs? Picks the cheapest deployable (strategy, p1·p2 "
                    "mesh, memory switches) point from the sweep lattice.")
    ap.add_argument("--model", default="resnet50",
                    help="resnet50 | vgg16 | cosmoflow | any configs/ LM name")
    ap.add_argument("--p", default="64",
                    help="PE count(s): '64', '8,64,1024', '1..1024' (pow2)")
    ap.add_argument("--batch", type=int, default=None,
                    help="fixed global batch B (default: weak scaling)")
    ap.add_argument("--batch-per-pe", type=float, default=2.0,
                    help="weak scaling: B = max(round(b·p), 1)")
    ap.add_argument("--dataset", type=int, default=None,
                    help="samples per epoch D (default: per-model)")
    ap.add_argument("--seq", type=int, default=4096, help="LM sequence length")
    ap.add_argument("--mem-cap-gib", type=float, default=None,
                    help="per-PE memory cap (default: system capacity)")
    ap.add_argument("--fallback", default=None,
                    help="strategy that wins ties / absorbs infeasibility")
    ap.add_argument("--strategies", default=None,
                    help="comma-separated subset to tune over (e.g. "
                         "'pipeline' to force a stage-parallel plan)")
    ap.add_argument("--no-switches", action="store_true",
                    help="pin memory switches off instead of sweeping all 16")
    ap.add_argument("--schedule", default="all",
                    help="pipeline schedule axis: 'all' (default) lets the "
                         "cheapest deployable schedule win, or pin one of "
                         "gpipe / one_f_one_b / interleaved")
    ap.add_argument("--virtual-stages", type=int, default=2,
                    help="v for the interleaved schedule (chunks per rank)")
    add_cluster_args(ap, default_system="paper")
    ap.add_argument("--no-overlap", action="store_true",
                    help="rank under the paper's serial comm accounting "
                         "instead of the overlap model (DESIGN.md §10)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny self-check (CI gate)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke()
    cluster = ClusterSpec.from_cli_args(args)

    stats, default_D = _model_stats(args.model, args.seq)
    # the CLI's recommendations must honor the same deployability gates as
    # plan_for_arch/train.py — never print a plan the executor rejects
    from ...parallel.schedules import pipeline_block_count, pipeline_supported
    mc = _model_config(args.model)
    can_pipe = pipeline_supported(mc) is None
    tm = TimeModel(cluster.system)
    cap = (args.mem_cap_gib * 2 ** 30 if args.mem_cap_gib
           else tm.system.mem_capacity)
    p_grid = parse_p_grid(args.p)
    print(f"# model={args.model} system={tm.system.name} "
          f"mem_cap={cap / 2**30:.1f}GiB switches="
          f"{'off' if args.no_switches else 'all 16 combos'}"
          + (f" topology={cluster.topology}" if cluster.topology else ""))
    print(f"{'p':>6s} {'strategy':16s} {'p1xp2':>11s} {'switches':24s} "
          f"{'ms/iter':>9s} {'mem_GiB':>8s}  bottleneck")
    for p in p_grid:
        B = args.batch or max(int(round(args.batch_per_pe * p)), 1)
        D = max(args.dataset or default_D, B)
        cfg = cluster.oracle_config(
            B=B, D=D, overlap=not args.no_overlap,
            virtual_stages=max(args.virtual_stages, 1))
        plan = autotune(stats, tm, cfg, p, mem_cap=cap,
                        switches=None if args.no_switches else "all",
                        schedules=("all" if args.schedule == "all"
                                   else (args.schedule,)),
                        fallback=args.fallback, cluster=cluster,
                        allow_pipeline=can_pipe,
                        max_stages=pipeline_block_count(mc),
                        strategies=tuple(s for s in
                                         (args.strategies or "").split(",")
                                         if s) or None)
        mark = " " if plan.feasible else "!"
        strat = (f"pipe:{plan.schedule}" if plan.strategy == "pipeline"
                 else plan.strategy)
        print(f"{p:>6d} {strat:16s} "
              f"{plan.p1:>5d}x{plan.p2:<5d} {plan.switch_str():24s} "
              f"{plan.per_iter_s * 1e3:>9.3f} "
              f"{plan.mem_bytes / 2**30:>8.2f} {mark} {plan.bottleneck}")
    return 0
