"""Oracle-vs-measured validation harness (paper §5.2, Fig. 3 methodology) at
p = 1; the port's counterpart of ``repro.core.validation``.

Runs a model's training step on one device, measures the iteration time,
projects the same point with the oracle, and reports the paper's accuracy
metric:

    accuracy = 1 − |T_projected − T_measured| / T_measured

One device runs the "data" strategy at p = 1 (a plain train step); the
other strategies need more than one rank and come with the parallel slice.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..nn.module import ShardingCtx
from ..optim.optimizers import OptimizerConfig
from ..training.steps import make_train_step, train_state
from .calibration import calibrate_host_system, time_fn
from .layer_stats import stats_for
from .oracle import STRATEGY_NAMES, OracleConfig, TimeModel, project

# oracle strategies with NO executable path, and why (so validate() skips
# them explicitly instead of falling through to an unknown name)
EXEC_SKIP = {
    "serial": "p=1 baseline needs no sharding rules; measure with a plain "
              "step instead",
}
# the strategies one device runs
EXEC_STRATEGY = ("data",)


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
    warm-up steps (``time_fn``). As every port train step does, it updates
    ``model``'s parameters in place (the reference starts from a fresh
    state instead; the time is the same)."""
    if strategy in EXEC_SKIP:
        raise NotImplementedError(
            f"oracle strategy {strategy!r} is not executable: "
            f"{EXEC_SKIP[strategy]}")
    if strategy not in STRATEGY_NAMES:
        raise KeyError(f"no executable mapping for oracle strategy "
                       f"{strategy!r}; known: {list(EXEC_STRATEGY)}, "
                       f"skipped: {sorted(EXEC_SKIP)}")
    if strategy not in EXEC_STRATEGY:
        raise NotImplementedError(
            f"oracle strategy {strategy!r} needs more than one rank; it "
            f"comes with the parallel slice (ROADMAP queue 1 item 6). One "
            f"device runs {list(EXEC_STRATEGY)}")
    opt = OptimizerConfig(name="sgd")
    step = make_train_step(model, opt, ctx)
    return time_fn(step, train_state(model, opt), batch, device=ctx.device,
                   iters=4, warmup=2)


def validate(model, model_cfg, batch, ctx: ShardingCtx, strategies, *,
             flops_per_sample: float, B: int,
             cluster=None) -> list[ValidationPoint]:
    """Measure + project each strategy at p = 1 on ``ctx.device``; paper
    Fig. 3.

    ``cluster``: a ClusterSpec describing the processing element (typically
    calibrated on another model) — projections then use it, as the paper's
    users project models the oracle was not calibrated on. Without it, the
    device is calibrated here on ``model`` itself (``calibrate_host_system``),
    the reference's default."""
    stats = stats_for(model_cfg)
    p = 1
    if cluster is None:
        sysm = calibrate_host_system(lambda b: model.loss_fn(b, ctx),
                                     model.parameters(), batch,
                                     flops_per_sample * B)
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
        proj = project(s, stats, tm, cfg, p)
        serial = project(s, stats, tm, replace(cfg, overlap=False), p)
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
