"""Oracle-vs-measured validation harness (paper §5.2, Fig. 3 methodology);
the port's counterpart of ``repro.core.validation``.

Runs a model's training step under each parallel strategy, measures the
iteration time, projects the same point with the oracle, and reports the
paper's accuracy metric:

    accuracy = 1 − |T_projected − T_measured| / T_measured

One device (no mesh) runs "data" at p = 1, a plain train step. On a mesh of
p ranks (``ShardingCtx.mesh``) "data", "filter", "channel", "spatial", "df"
and "ds" run as the rules tables of ``EXEC_STRATEGY``; as in the reference,
"spatial" is measured under the "ds" rules on the whole (data, model) mesh
but projected as pure spatial parallelism at p. "pipeline", "summa" and
"ep" raise, each naming its ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..launch.build import shard_batch
from ..nn.module import ShardingCtx
from ..optim.optimizers import OptimizerConfig
from ..parallel.sharded import sharded_copy
from ..parallel.strategies import make_rules
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
    "summa": "the 2-D tensor grid is parallel/summa.py (ROADMAP queue 1 "
             "item 8)",
    "pipeline": "the stage executor is parallel/schedules (ROADMAP queue 1 "
                "item 8)",
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


def measure_step(model, batch, ctx: ShardingCtx,
                 strategy: str = "data") -> float:
    """Measured per-iteration time of a real train step (SGD, the port's
    ``make_train_step``) on ``ctx.device``: the median of 4 steps after 2
    warm-up steps (``time_fn``).

    Without a mesh, "data" at p = 1: the step updates ``model``'s parameters
    in place (the reference starts from a fresh state instead; the time is
    the same). On a mesh of p ranks, ``model`` and ``batch`` are the whole
    model and batch (the same on every rank): the step runs on this rank's
    blocks of a copy, under the strategy's rules, and every rank returns
    the slowest rank's time."""
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
                       device=ctx.device, iters=4, warmup=2)
    if strategy in NOT_PORTED:
        raise NotImplementedError(
            f"oracle strategy {strategy!r} is not ported: "
            f"{NOT_PORTED[strategy]}")
    ctx_s = replace(ctx, rules=make_rules(EXEC_STRATEGY[strategy]))
    local = sharded_copy(model, ctx_s)
    step = make_train_step(local, opt, ctx_s)
    t = time_fn(step, train_state(local, opt), shard_batch(batch, ctx_s),
                device=ctx.device, iters=4, warmup=2)
    return _slowest(t, ctx.mesh)


def validate(model, model_cfg, batch, ctx: ShardingCtx, strategies, *,
             flops_per_sample: float, B: int,
             cluster=None) -> list[ValidationPoint]:
    """Measure + project each strategy at p = the mesh's rank count (1
    without one) on ``ctx.device``; paper Fig. 3.

    ``model`` and ``batch`` are whole (on every rank, the same).
    ``cluster``: a ClusterSpec describing the processing element (typically
    calibrated on another model, or by ``calibrate_cluster`` on the mesh) —
    projections then use it. Without it, the device is calibrated here on
    ``model`` itself (``calibrate_host_system``, with α/β per mesh axis),
    the reference's default; ranks that timeshare a device (a mesh on one
    card, or the CPU) get 1/p of its measured rate, as in the reference."""
    stats = stats_for(model_cfg)
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
    cfg = OracleConfig(B=B, D=B, **kw)  # 1 iteration/epoch
    tm = TimeModel(sysm)
    points = []
    for s in strategies:
        if s in EXEC_SKIP:      # explicitly not executable; see EXEC_SKIP
            continue
        meas = measure_step(model, batch, ctx, s)
        pkw = {}
        if s in ("df", "ds", "ep"):
            pkw = dict(p1=ctx.mesh.shape["data"], p2=ctx.mesh.shape["model"])
        proj = project(s, stats, tm, cfg, p, **pkw)
        serial = project(s, stats, tm, replace(cfg, overlap=False), p, **pkw)
        points.append(ValidationPoint(s, p, meas, proj.total_s,
                                      serial.total_s))
    return points


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
