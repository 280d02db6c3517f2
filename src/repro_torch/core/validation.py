"""Oracle-vs-measured validation harness (paper §5.2, Fig. 3 methodology);
the port's counterpart of ``repro.core.validation``.

Runs a model's training step under each parallel strategy, measures the
iteration time, projects the same point with the oracle, and reports the
paper's accuracy metric:

    accuracy = 1 − |T_projected − T_measured| / T_measured

One device (no mesh) runs "data" at p = 1, a plain train step. On a mesh of
p ranks (``ShardingCtx.mesh``) "data", "filter", "channel", "spatial", "df"
and "ds" run as the rules tables of ``EXEC_STRATEGY``, for the CNNs and the
LMs (an LM's layer stats at the ``S`` tokens a sequence of its batch); as
in the reference,
"spatial" is measured under the "ds" rules on the whole (data, model) mesh
but projected as pure spatial parallelism at p. "pipeline" runs the stage
executor (``parallel/schedules``) with all p ranks as stages of a (1, p)
mesh over the same world, the paper's pure layer strategy, for the CNNs
and the LMs (an LM cut on its per-layer costs at the batch's sequence
length). "summa" runs an attention LM's step under the "summa" table on
the (p/(r·c), r, c) grid of ``grid`` = (r, c) over the same world
(``launch.mesh.make_grid_mesh``) and projects it at p1 = p/(r·c),
p2 = r·c, p2r = r, p2c = c, as the reference does; a CNN or an SSM model
there raises (ROADMAP queue 1 item 8). "ep" raises, naming its ROADMAP
item. ``measure_serving`` replays a request trace through the serving
engine, on one device or across the ranks of a (p1, p2) mesh under
serve_tp or serve_seqkv.

The reference's ``validate`` never measures the pipeline on a CNN: it
bounds the stage count by ``cfg.n_layers``, which the CNN configs lack, so
the bound is 0 and the row is skipped (and its ``measure_step`` reads
``batch["tokens"]``). The port bounds it by ``pipeline_block_count``, the
executor's own ceiling, as the reference's docstring intends (ROADMAP
caveat k).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, replace

import numpy as np

from ..launch.build import shard_batch
from ..launch.mesh import make_grid_mesh
from ..nn.module import ShardingCtx
from ..optim.optimizers import OptimizerConfig
from ..parallel.sharded import sharded_copy
from ..parallel.strategies import make_rules
from ..parallel.summa import summa_supported
from ..training.steps import make_train_step, train_state
from .calibration import _slowest, calibrate_host_system, time_fn
from .layer_stats import stats_for
from .oracle import STRATEGY_NAMES, OracleConfig, TimeModel, project

# oracle-strategy name → executable rules-table name (parallel/strategies.py)
EXEC_STRATEGY = {
    "data": "data",
    "filter": "filter",
    "channel": "channel",
    "spatial": "ds",
    "df": "df",
    "ds": "ds",
    "ep": "ep_df",
    "summa": "summa",
    "pipeline": "pipeline",
}
# mapped strategies the port does not run yet, and where they are queued
NOT_PORTED = {
    "ep": "expert parallelism needs MoE (ROADMAP queue 1 item 10)",
}

# oracle strategies with NO executable path, and why (so validate() skips
# them explicitly instead of falling through to an unknown name)
EXEC_SKIP = {
    "serial": "p=1 baseline needs no sharding rules; measure with a plain "
              "step instead",
}


@dataclass
class ValidationPoint:
    strategy: str
    p: int
    measured_s: float
    projected_s: float            # overlap model (OracleConfig default)
    projected_serial_s: float = 0.0   # paper accounting (overlap=False)

    def _acc(self, proj: float) -> float:
        if self.measured_s <= 0:
            return 0.0
        return 1.0 - abs(proj - self.measured_s) / self.measured_s

    @property
    def accuracy(self) -> float:
        return self._acc(self.projected_s)

    @property
    def accuracy_serial(self) -> float:
        """Accuracy of the no-overlap (serial-comm) projection."""
        return self._acc(self.projected_serial_s)


def measure_step(model, batch, ctx: ShardingCtx, strategy: str = "data", *,
                 segments: int = 8, schedule: str = "gpipe",
                 virtual_stages: int = 2,
                 grid: tuple[int, int] | None = None, iters: int = 4,
                 warmup: int = 2) -> float:
    """Measured per-iteration time of a real train step (SGD, the port's
    ``make_train_step``) on ``ctx.device``: the median of ``iters`` steps
    after ``warmup`` warm-up steps (``time_fn``; 4 and 2, the
    reference's).

    Without a mesh, "data" at p = 1: the step updates ``model``'s parameters
    in place (the reference starts from a fresh state instead; the time is
    the same). On a mesh of p ranks, ``model`` and ``batch`` are the whole
    model and batch (the same on every rank): the step runs on this rank's
    blocks of a copy, under the strategy's rules, and every rank returns
    the slowest rank's time.

    "pipeline" runs ``make_pipeline_train_step`` on a copy of the model, all
    p ranks as stages of a (1, p) mesh (``Mesh.regrid``), under
    ``schedule`` with ``segments`` microbatches (``virtual_stages``: the
    interleaved v), cut by the block costs of the oracle's layer stats (an
    LM's at its batch's sequence length).

    "summa" runs the step on the (p/(r·c), r, c) grid of the same world,
    ``grid`` = (r, c), under the "summa" rules: an attention LM's
    projections as SUMMA (``parallel/summa.py``)."""
    if strategy in EXEC_SKIP:
        raise NotImplementedError(
            f"oracle strategy {strategy!r} is not executable: "
            f"{EXEC_SKIP[strategy]}")
    if strategy not in STRATEGY_NAMES:
        raise KeyError(f"no executable mapping for oracle strategy "
                       f"{strategy!r}; known: {sorted(EXEC_STRATEGY)}, "
                       f"skipped: {sorted(EXEC_SKIP)}")
    opt = OptimizerConfig(name="sgd")
    if not ctx.sharded:
        if strategy != "data":
            raise NotImplementedError(
                f"oracle strategy {strategy!r} needs a mesh of more than one "
                f"rank (ShardingCtx(mesh=launch.mesh.make_host_mesh(...)); "
                f"the parallel slice, ROADMAP queue 1 item 6). One device "
                f"runs 'data'")
        step = make_train_step(model, opt, ctx)
        return time_fn(step, train_state(model, opt), batch,
                       device=ctx.device, iters=iters, warmup=warmup)
    if strategy in NOT_PORTED:
        raise NotImplementedError(
            f"oracle strategy {strategy!r} is not ported: "
            f"{NOT_PORTED[strategy]}")
    if strategy == "pipeline":
        from ..parallel.schedules import (make_pipeline_train_step,
                                          pipeline_block_costs)
        mesh = ctx.mesh.regrid(1, ctx.mesh.size)
        local = copy.deepcopy(model)
        costs = None
        if "tokens" in batch:
            costs = pipeline_block_costs(local, stats_for(
                model.cfg, batch["tokens"].shape[1]))
        step = make_pipeline_train_step(
            local, opt, replace(ctx, mesh=mesh, rules=make_rules("pipeline")),
            segments=segments, schedule=schedule,
            virtual_stages=virtual_stages, block_costs=costs)
        t = time_fn(step, train_state(local, opt), batch, device=ctx.device,
                    iters=iters, warmup=warmup)
        return _slowest(t, mesh)
    mesh = ctx.mesh
    if strategy == "summa":
        reason = summa_supported(model)
        if reason is not None:
            raise NotImplementedError(reason)
        if grid is None:
            raise ValueError("summa needs grid=(p2r, p2c)")
        r, c = grid
        if mesh.size % (r * c):
            raise ValueError(f"grid {r}x{c} does not divide p={mesh.size}")
        mesh = make_grid_mesh(mesh, mesh.size // (r * c), r, c)
    ctx_s = replace(ctx, mesh=mesh, rules=make_rules(EXEC_STRATEGY[strategy]))
    local = sharded_copy(model, ctx_s)
    step = make_train_step(local, opt, ctx_s)
    t = time_fn(step, train_state(local, opt), shard_batch(batch, ctx_s),
                device=ctx.device, iters=iters, warmup=warmup)
    return _slowest(t, mesh)


def validate(model, model_cfg, batch, ctx: ShardingCtx, strategies, *,
             flops_per_sample: float, B: int, S: int = 128,
             oracle_cfg_kw: dict | None = None, cluster=None,
             grid: tuple[int, int] | None = None, iters: int = 4,
             warmup: int = 2) -> list[ValidationPoint]:
    """Measure + project each strategy at p = the mesh's rank count (1
    without one) on ``ctx.device``; paper Fig. 3. ``S``: an LM's tokens a
    sequence, for its layer stats (a CNN's ignore it).

    ``model`` and ``batch`` are whole (on every rank, the same).
    "pipeline" is skipped, with the reason printed, where the executor
    cannot deploy the model or p exceeds its block count
    (``pipeline_block_count``); otherwise it is measured and projected at
    the segment count the step runs (``clip_segments(B, cfg.segments)``).
    ``cluster``: a ClusterSpec describing the processing element (typically
    calibrated on another model, or by ``calibrate_cluster`` on the mesh) —
    projections then use it. Without it, the device is calibrated here on
    ``model`` itself (``calibrate_host_system``, with α/β per mesh axis),
    the reference's default; ranks that timeshare a device (a mesh on one
    card, or the CPU) get 1/p of its measured rate, as in the reference.
    ``oracle_cfg_kw``: ``OracleConfig`` keywords the projections take
    (a session's overrides); the cluster's φ/σ tables fill the rest.
    ``grid``: (p2r, p2c) for "summa", measured on that grid of the same
    world and projected at the matching lattice point. ``iters`` and
    ``warmup``: each point's measured and warm-up steps
    (``measure_step``)."""
    stats = stats_for(model_cfg, S)
    p = ctx.mesh.size if ctx.sharded else 1
    if cluster is None:
        whole = ShardingCtx(ctx.device, ctx.use_pallas)
        sysm = calibrate_host_system(lambda b: model.loss_fn(b, whole),
                                     model.parameters(), batch,
                                     flops_per_sample * B,
                                     mesh=ctx.mesh if p > 1 else None)
        sysm = replace(sysm, peak_flops=sysm.peak_flops / p)
        kw = {}
    else:
        sysm, kw = cluster.system, cluster.oracle_kw()
    kw = {**kw, **(oracle_cfg_kw or {})}
    cfg = OracleConfig(B=B, D=B, **kw)  # 1 iteration/epoch
    tm = TimeModel(sysm)
    points = []
    for s in strategies:
        if s in EXEC_SKIP:      # explicitly not executable; see EXEC_SKIP
            continue
        cfg_s = cfg
        if s == "pipeline":
            from ..parallel.schedules import (clip_segments,
                                              pipeline_block_count,
                                              pipeline_supported)
            reason = pipeline_supported(model_cfg)
            n_blocks = pipeline_block_count(model_cfg)
            if reason is None and p > n_blocks:
                reason = f"p={p} stages exceed the model's {n_blocks} blocks"
            if reason is not None:
                print(f"validate: skipping pipeline — {reason}")
                continue
            cfg_s = replace(cfg, segments=clip_segments(B, cfg.segments))
        meas = measure_step(model, batch, ctx, s, segments=cfg_s.segments,
                            grid=grid, iters=iters, warmup=warmup)
        pkw = {}
        if s in ("df", "ds", "ep"):
            pkw = dict(p1=ctx.mesh.shape["data"], p2=ctx.mesh.shape["model"])
        elif s == "summa":
            r, c = grid
            pkw = dict(p1=p // (r * c), p2=r * c, p2r=r, p2c=c)
        proj = project(s, stats, tm, cfg_s, p, **pkw)
        serial = project(s, stats, tm, replace(cfg_s, overlap=False), p,
                         **pkw)
        points.append(ValidationPoint(s, p, meas, proj.total_s,
                                      serial.total_s))
    return points


def measure_serving(model, ctx: ShardingCtx, strategy: str, serve_cfg,
                    requests, *, warmup: bool = True,
                    honor_arrivals: bool = False):
    """Measured serving replay: the continuous-batching engine
    (``serve.engine``) with ``model`` on ``ctx.device``, fed ``requests``
    (a trace from ``TrafficModel.trace``). Returns the engine's
    ServeReport: the tok/s and latency percentiles the serving oracle is
    validated against.

    ``strategy`` is a serving layout, "serve_tp" or "serve_seqkv". Across
    ranks (a sharded ``ctx`` over a (p1, p2) mesh) the replay runs under
    that layout's rules at width p2, with ``kv_shards`` 1 (serve_tp, the
    cache split on its kv heads) or p2 (serve_seqkv, split on its span),
    as the serving oracle prices them, and with p1 > 1 each decode batch's
    rows split over the p1 data groups (``serve.engine``: one schedule
    whose batch is split, where the serving oracle prices p1 independent
    replicas); one device serves either at width 1 with one shard. ``model`` is whole (this rank's blocks are cut here) or
    already this rank's blocks (``launch.build.build_model`` on the ctx:
    both layouts place the weights alike, and a full-width model whole on
    every rank would not fit). Every rank runs the replay and returns its
    report; rank 0's times are the ones to read.

    ``warmup`` replays the trace once first (and ``reset``s), so the first
    calls' costs (cuBLAS's choices, the kernels' builds) stay out of the
    measured wall clock; ``honor_arrivals=False`` (the default) replays
    closed-loop, measuring capacity rather than queueing."""
    from ..serve.engine import Engine, serving_mesh
    if strategy not in ("serve_tp", "serve_seqkv"):
        raise ValueError(f"serving layout {strategy!r}: the engine serves "
                         f"under serve_tp or serve_seqkv")
    width = 1
    if ctx.sharded:
        ctx = replace(ctx, rules=make_rules(strategy))
        serving_mesh(ctx, serve_cfg.max_batch)
        width = ctx.mesh.shape["model"]
        if not all(hasattr(p, "place") for p in model.parameters()):
            model = sharded_copy(model, ctx)
    shards = width if strategy == "serve_seqkv" else 1
    if serve_cfg.kv_shards != shards:
        raise ValueError(f"{strategy} at width {width} takes kv_shards="
                         f"{shards}, not {serve_cfg.kv_shards}")
    eng = Engine(model, ctx, serve_cfg)
    if warmup:
        eng.run(requests, honor_arrivals=False)
        eng.reset()
    return eng.run(requests, honor_arrivals=honor_arrivals)


def measure_schedule_bubble(model, make_batch, ctx: ShardingCtx, *,
                            schedule: str = "gpipe",
                            virtual_stages: int = 2, S_small: int = 4,
                            S_large: int = 8, microbatch: int = 1) -> dict:
    """Measured bubble fraction of one pipeline schedule (paper §5.2
    methodology extended to the schedule axis).

    Runs the stage executor at two microbatch counts with a FIXED
    per-microbatch size (``make_batch(S · microbatch)`` builds the whole
    batch), fits the step time as t(S) = a·S + b (a: the steady-state cost
    of a microbatch; b: the fill/drain overhead) and reports the bubble
    fraction b / t(S_large). A negative b (noise, or times that do not
    grow linearly in S) counts as no bubble; ``intercept_s`` keeps b as
    fitted, so such a fit shows."""
    times = {}
    for S in (S_small, S_large):
        times[S] = measure_step(model, make_batch(S * microbatch), ctx,
                                "pipeline", segments=S, schedule=schedule,
                                virtual_stages=virtual_stages)
    a = (times[S_large] - times[S_small]) / float(S_large - S_small)
    fit = times[S_small] - a * S_small
    b, t = max(fit, 0.0), times[S_large]
    return {"schedule": schedule, "S_small": S_small, "S_large": S_large,
            "per_microbatch_s": a, "bubble_s": b, "intercept_s": fit,
            "t_small_s": times[S_small], "t_large_s": t,
            "bubble_fraction": b / t if t > 0 else 0.0}


def schedule_winner(stats, tm, cfg, p: int) -> str:
    """The oracle's cheapest pipeline schedule at p: the schedule axis of
    the sweep restricted to the pipeline strategy. Ties break in
    PIPELINE_SCHEDULES order (gpipe first)."""
    from .sweep import sweep
    res = sweep(stats, tm, cfg, [p], strategies=("pipeline",),
                schedules="all")
    if len(res) == 0:
        raise ValueError("pipeline does not apply to this layer set")
    keep = res.feasible if res.feasible.any() else np.ones(len(res), bool)
    idx = np.flatnonzero(keep)
    return str(res.schedule[idx[np.argmin(res.total_s[idx])]])


def accuracy_report(points: list[ValidationPoint]) -> str:
    lines = [f"{'strategy':10s} {'measured_ms':>12s} {'projected_ms':>13s} "
             f"{'accuracy':>9s} {'serial_ms':>10s} {'acc_serial':>10s}"]
    for pt in points:
        lines.append(f"{pt.strategy:10s} {pt.measured_s*1e3:12.2f} "
                     f"{pt.projected_s*1e3:13.2f} {pt.accuracy*100:8.1f}% "
                     f"{pt.projected_serial_s*1e3:10.2f} "
                     f"{pt.accuracy_serial*100:9.1f}%")
    mean = np.mean([pt.accuracy for pt in points])
    lines.append(f"{'MEAN':10s} {'':12s} {'':13s} {mean*100:8.1f}%")
    return "\n".join(lines)
