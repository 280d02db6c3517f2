"""Session facade: ``Oracle(arch, shape, cluster)``, one object from
calibration to deployment (counterpart of ``repro.api``).

The paper's workflow is a loop: describe the machine, project strategies,
pick a plan, deploy it, measure, and feed the measurements back into the
machine description. The session binds (arch × input shape × ClusterSpec)
once and exposes the loop as methods:

    from repro_torch.api import Oracle
    ses  = Oracle("resnet50", "train_4k", "paper")
    proj = ses.project("df", 64)          # one Table-3 row
    res  = ses.sweep([8, 64, 1024])       # the vectorized lattice
    plan = ses.tune(64)                   # cheapest deployable TunedPlan
    cell = ses.build(mesh)                # deploy the plan (None: one device)
    pts  = ses.validate(ctx)              # measured vs projected (Fig. 3)
    fit  = ses.calibrate(mesh)            # fitted ClusterSpec, applied to
                                          # the session

Every method delegates to the port's engines (``core.oracle``,
``core.sweep``, ``core.advisor``, ``core.autotune``, ``serve.oracle``,
``core.validation``, ``core.calibration``, ``launch.build.build_cell``),
so a session's numbers equal the direct calls' and the reference's session
to 1e-12 (``python -m repro_torch.api --parity``,
tests/test_torch_api.py). The default cluster is the reference's, the TPU
deployment target ``plan_for_arch`` assumes, so ``tune`` returns the
reference's plan.

The measured methods run the smoke model, as the reference's do (an
``ArchConfig`` whose ``smoke_model`` is its full model measures that), on
the caller's device: ``validate`` on a ``ShardingCtx`` (its mesh, or one
device), ``calibrate`` on a mesh or on one device (``device``: ``cuda``
unless the caller asks for the CPU; there is no fallback). Not ported:
``dryrun`` and ``roofline_hw`` (the dry-run tools, ROADMAP queue 1 item
12) and ``tune_kernels`` (the Hopper kernel tuner, item 11); they raise.

CLI:  python -m repro_torch.api --parity      # session ↔ direct parity gate
      python -m repro_torch.api --smoke       # project → tune → build, and
                                              # one step of the built cell
      python -m repro_torch.api --chaos [--device cpu]   # elastic smoke
      python -m repro_torch.api --calibrate --out fit.json [--device cpu]
      python -m repro_torch.api --serve-tune --arch qwen1.5-4b --p 8
"""
from __future__ import annotations

import argparse
import json
import sys

from .core.cluster import ClusterSpec, Torus  # noqa: F401 (re-export)

_SES_DEFAULT_CLUSTER = "tpu"     # the deployment target plan_for_arch assumes


class Oracle:
    """One oracle session over (arch × input shape × ClusterSpec).

    ``arch``: a registered arch name or an ``ArchConfig``. ``shape``: a
    ``SHAPES`` name (default ``train_4k``) or a ``ShapeSpec``. ``cluster``:
    a ClusterSpec, a preset name ("paper"/"tpu"/"host") or a SystemModel;
    the TPU deployment target by default. ``batch``/``dataset`` override
    the shape's global batch and samples an epoch (both default to one
    iteration an epoch); other keywords go into the session's
    ``OracleConfig``."""

    def __init__(self, arch, shape: str = "train_4k", cluster=None, *,
                 smoke: bool = False, batch: int | None = None,
                 dataset: int | None = None, seq: int | None = None,
                 mem_cap: float | None = None, **oracle_kw):
        from .configs.base import SHAPES
        from .core.autotune import stats_for_model
        self.arch_cfg = self._resolve_arch(arch)
        self.shape = SHAPES[shape] if isinstance(shape, str) else shape
        self.smoke = smoke
        self.model_cfg = (self.arch_cfg.smoke_model if smoke
                          else self.arch_cfg.model)
        self.seq = seq or self.shape.seq_len
        self.stats = stats_for_model(self.model_cfg, self.seq)
        self.B = batch or self.shape.global_batch
        self.D = dataset or self.B
        self.mem_cap = mem_cap
        self._oracle_kw = dict(oracle_kw)
        self._bind(ClusterSpec.coerce(cluster) or
                   ClusterSpec.of(_SES_DEFAULT_CLUSTER))

    @staticmethod
    def _resolve_arch(arch):
        from .configs import get_config
        return get_config(arch) if isinstance(arch, str) else arch

    def _bind(self, cluster: ClusterSpec) -> None:
        """(Re)derive the projection state from a machine description, the
        one place the TimeModel and OracleConfig are built."""
        from .core.oracle import TimeModel
        self.cluster = cluster
        self.tm = TimeModel(cluster.system)
        self.cfg = cluster.oracle_config(B=self.B, D=self.D,
                                         **self._oracle_kw)

    def with_cluster(self, cluster) -> "Oracle":
        """A new session on another machine, everything else shared."""
        ses = object.__new__(Oracle)
        ses.__dict__.update(self.__dict__)
        ses._oracle_kw = dict(self._oracle_kw)
        ses._bind(ClusterSpec.coerce(cluster))
        return ses

    # -- projection ----------------------------------------------------------

    def project(self, strategy: str, p: int, p1: int | None = None,
                p2: int | None = None):
        """One Table-3 row at p PEs."""
        from .core.oracle import project
        return project(strategy, self.stats, self.tm, self.cfg, p,
                       p1=p1, p2=p2)

    def project_all(self, p: int, strategies=None):
        from .core.oracle import STRATEGY_NAMES, project_all
        return project_all(self.stats, self.tm, self.cfg, p,
                           strategies or STRATEGY_NAMES)

    def sweep(self, p_grid, strategies=None, **kw):
        """The strategy × p × p1·p2 lattice; the session's topology prunes
        the splits it cannot host."""
        from .core.oracle import STRATEGY_NAMES
        from .core.sweep import sweep
        kw.setdefault("cluster", self.cluster)
        return sweep(self.stats, self.tm, self.cfg, p_grid,
                     strategies or STRATEGY_NAMES, **kw)

    def advise(self, p: int, **kw):
        from .core.advisor import advise
        kw.setdefault("mem_cap", self.mem_cap)
        kw.setdefault("cluster", self.cluster)
        return advise(self.stats, self.tm, self.cfg, p, **kw)

    def roofline_hw(self):
        raise NotImplementedError(
            "the roofline HardwareSpec belongs to the dry-run tools "
            "(core/roofline.py), ROADMAP queue 1 item 12")

    # -- serving -------------------------------------------------------------

    def serve_project(self, traffic, p: int, *, strategy: str = "serve_tp",
                      p2: int | None = None, kv_shards: int | None = None,
                      max_batch: int = 8, **kw):
        """One serving row priced under ``traffic`` (a TrafficModel)."""
        from .serve.oracle import price_serving
        p2 = p2 or p
        kv = kv_shards if kv_shards is not None else (
            1 if strategy == "serve_tp" else p2)
        return price_serving(self.model_cfg, self.cluster, strategy,
                             p // p2, p2, kv, max_batch, traffic, **kw)

    def serve_sweep(self, traffic, p: int, **kw):
        """Every (strategy, p1·p2, kv_shards, max_batch) serving row."""
        from .serve.oracle import serve_sweep
        return serve_sweep(self.model_cfg, self.cluster, p, traffic, **kw)

    def serve_tune(self, traffic, p: int, slo_p99: float, **kw):
        """The highest-throughput serving plan meeting the p99 SLO."""
        from .serve.oracle import serve_tune
        return serve_tune(self.model_cfg, self.cluster, p, traffic,
                          slo_p99, **kw)

    # -- decision ------------------------------------------------------------

    def tune(self, p: int, *, switches="all",
             model_width: int | None = None,
             allow_pipeline: bool | None = None):
        """The cheapest deployable TunedPlan at p, honouring the cluster's
        torus topology."""
        from .core.autotune import plan_for_arch
        return plan_for_arch(self.arch_cfg, self.shape, p,
                             cluster=self.cluster, cfg=self.cfg,
                             stats=self.stats, smoke=self.smoke,
                             mem_cap=self.mem_cap, switches=switches,
                             model_width=model_width,
                             allow_pipeline=allow_pipeline)

    def tune_kernels(self, **kw):
        raise NotImplementedError(
            "tuning the kernels' tiles for this cluster is the Hopper "
            "kernel autotuner, ROADMAP queue 1 item 11")

    # -- deployment ----------------------------------------------------------

    def build(self, mesh, plan=None, **kw):
        """Deploy a plan (default: ``tune()`` at the mesh's rank count,
        constrained to its model width) as a ``BuiltCell``
        (``launch.build.build_cell``); ``mesh`` is the port's ``Mesh`` or
        None for one device (``device=``, ``cuda`` by default)."""
        from .launch.build import build_cell, mesh_device_count
        if plan is None:
            plan = self.tune(mesh_device_count(mesh),
                             model_width=None if mesh is None
                             else mesh.shape.get("model"))
        kw.setdefault("system", self.cluster)
        return build_cell(self.arch_cfg, self.shape, mesh, "auto",
                          smoke=self.smoke, plan=plan, **kw)

    def dryrun(self, mesh=None, plan=None, **kw):
        raise NotImplementedError(
            "the dry-run (lowering a built cell and reading its memory) is "
            "launch/dryrun.py, ROADMAP queue 1 item 12")

    # -- measurement (closing the loop) --------------------------------------

    def _measured_setup(self, device, p: int, batch_size=None, seq=None):
        """The smoke model (whole, seed 0) on ``device`` and its synthetic
        batch 0: (model, model config, batch, b, S, forward FLOPs a
        sample)."""
        from .core.autotune import stats_for_model
        from .data.pipeline import Loader
        from .launch.build import build_model
        from .launch.train import data_config_for
        from .nn.module import ShardingCtx
        mc = self.arch_cfg.smoke_model
        model = build_model(self.arch_cfg, ShardingCtx(device), smoke=True)
        b = batch_size or max(p, 8)
        S = seq or min(self.seq, 128)
        batch = Loader(data_config_for(mc, b, S), _model_device(model)
                       ).batch_at(0)
        flops = float(sum(s.flops_fwd for s in stats_for_model(mc, S)))
        return model, mc, batch, b, S, flops

    def validate(self, ctx, strategies=("data",), *, batch_size=None,
                 seq=None, use_cluster: bool = False):
        """Measure against project each strategy at p = the ctx's rank count
        (paper Fig. 3) on the smoke model, on ``ctx.device``. By default the
        device is calibrated in place (the reference's default);
        ``use_cluster=True`` projects with this session's cluster."""
        from .core.validation import validate
        p = ctx.mesh.size if ctx.sharded else 1
        model, mc, batch, b, S, flops = self._measured_setup(
            ctx.device, p, batch_size, seq)
        # the projections take the session's model: the cluster's φ/σ and
        # the session's OracleConfig overrides
        kw = {**self.cluster.oracle_kw(), **self._oracle_kw}
        return validate(model, mc, batch, ctx, strategies,
                        flops_per_sample=flops, B=b, S=S, oracle_cfg_kw=kw,
                        cluster=self.cluster if use_cluster else None)

    def calibrate(self, mesh=None, *, apply: bool = True,
                  compute: bool = True, batch_size: int = 8,
                  seq: int | None = None, device="cuda"):
        """The measurement harness (``core.calibration.calibrate_cluster``)
        on a mesh, or on one ``device``: α/β per mesh axis, contention φ,
        overlap σ, and with ``compute`` the FLOP rate of a serial step of
        the smoke model. Returns the fitted ClusterSpec; with ``apply`` the
        session rebinds to it. The raw measurements are kept on
        ``self.last_measurements``."""
        from .core.calibration import calibrate_cluster
        kw = {}
        if compute:
            dev = mesh.device if mesh is not None else device
            model, mc, batch, b, S, flops = self._measured_setup(
                dev, mesh.size if mesh is not None else 1, batch_size, seq)
            from .nn.module import ShardingCtx
            one = ShardingCtx(_model_device(model))
            kw = dict(loss_fn=lambda b_: model.loss_fn(b_, one),
                      params=model.parameters(), batch=batch,
                      flops_per_step=flops * b)
        spec, ms = calibrate_cluster(mesh, base=self.cluster, **kw)
        self.last_measurements = ms
        if apply:
            self._bind(spec)
        return spec

    def describe(self) -> str:
        return (f"Oracle[{self.arch_cfg.name} × {self.shape.name}"
                f"{' (smoke)' if self.smoke else ''}] B={self.cfg.B} "
                f"D={self.cfg.D}\n{self.cluster.describe()}")


def _model_device(model):
    return next(model.parameters()).device


# ---------------------------------------------------------------------------
# CLI: smoke / parity / calibrate / serve-tune
# ---------------------------------------------------------------------------

def _smoke(device: str) -> int:
    """Session smoke: project → tune → build on the host cluster, then one
    step of the built cell on ``device`` (the dry-run is not ported)."""
    import math

    import numpy as np

    from .data.pipeline import Loader
    from .launch.build import shard_batch
    from .launch.train import data_config_for
    from .training.steps import train_state
    ses = Oracle("qwen1.5-4b", "train_4k", "host", smoke=True,
                 batch=8, seq=128)
    print(ses.describe())
    proj = ses.project("data", 1)
    assert proj.total_s > 0 and proj.feasible, proj
    plan = ses.tune(1)
    print(plan.describe())
    assert plan.p == 1 and plan.p1 * plan.p2 == 1
    res = ses.sweep([1], ("data",), switches=None)
    i = int(np.flatnonzero((res.p1 == proj.p1) & (res.p2 == proj.p2))[0])
    assert abs(res.total_s[i] - proj.total_s) <= 1e-12 * abs(proj.total_s)
    cell = ses.build(None, plan=plan, device=device, q_chunk=64)
    state = train_state(cell.model, cell.meta["opt"], cell.ctx)
    batch = Loader(data_config_for(ses.model_cfg, 8, 128),
                   cell.ctx.device).batch_at(0)
    state, m = cell.step_fn(state, shard_batch(batch, cell.ctx))
    loss = float(m["loss"])
    print(f"built cell: strategy={cell.strategy} kind={cell.kind} "
          f"remat={cell.meta['remat']} args: tokens "
          f"{tuple(cell.args[1]['tokens'].shape)}; one step loss {loss:.6g}")
    assert cell.kind == "train" and math.isfinite(loss)
    print("repro_torch.api --smoke OK")
    return 0


def _parity() -> int:
    """Session ↔ direct-call parity gate: the session's results match the
    engines' own signatures to ≤1e-12."""
    import numpy as np

    from .configs import get_config
    from .core import advisor, oracle
    from .core.autotune import autotune, plan_for_arch
    from .core.hardware import PAPER_V100_CLUSTER
    from .core.layer_stats import stats_for
    from .core.sweep import sweep as direct_sweep
    stats = stats_for(get_config("resnet50").model)
    tm = oracle.TimeModel(PAPER_V100_CLUSTER)
    worst = 0.0
    for p in (8, 64, 1024):
        cfg = oracle.OracleConfig(B=2 * p, D=1_281_167)
        ses = Oracle("resnet50", "train_4k", "paper", batch=2 * p,
                     dataset=1_281_167)
        for s in ("data", "df", "filter", "spatial"):
            a = oracle.project(s, stats, tm, cfg, p).total_s
            b = ses.project(s, p).total_s
            worst = max(worst, abs(a - b) / max(abs(a), 1e-30))
        ra = direct_sweep(stats, tm, cfg, [p])
        rb = ses.sweep([p])
        assert len(ra) == len(rb)
        worst = max(worst, float(np.max(
            np.abs(ra.total_s - rb.total_s) /
            np.maximum(np.abs(ra.total_s), 1e-30))))
        reca = advisor.advise(stats, tm, cfg, p)
        recb = ses.advise(p)
        assert reca.best.strategy == recb.best.strategy
        worst = max(worst, abs(reca.best.total_s - recb.best.total_s)
                    / abs(reca.best.total_s))
        pa = autotune(stats, tm, cfg, p, allow_pipeline=False)
        pb = autotune(stats, tm, cfg, p, allow_pipeline=False,
                      cluster=ses.cluster)
        assert pa == pb, (pa, pb)
    for p in (8, 64):
        want = plan_for_arch(get_config("resnet50"), "train_4k", p)
        got = Oracle("resnet50", "train_4k").tune(p)
        assert want == got, (want, got)
    assert worst <= 1e-12, f"session/direct drift {worst:.2e}"
    print(f"repro_torch.api --parity OK (max rel drift {worst:.2e})")
    return 0


# the chaos smoke: a tiny fp32 LM, global batch B of S tokens, N steps, a
# checkpoint every EVERY, torus dim 0 lost before step KILL, on RANKS ranks
CHAOS = dict(V=64, D=32, L=2, B=8, S=32, N=16, KILL=10, EVERY=4, RANKS=4)


def chaos_setup():
    """(session, data config, optimizer config) of the chaos smoke: a tiny
    uniform fp32 LM (the reference's, with 4 kv heads: the port's
    attention takes no grouped kv heads) on the host cluster with a (2, 2)
    torus whose model axis may ring only in dim 1, AdamW without ZeRO-1
    (each plan sets its own)."""
    from dataclasses import replace

    import torch

    from .configs.base import ArchConfig, ShapeSpec
    from .data.pipeline import DataConfig
    from .models.transformer import LMConfig
    from .nn.attention import AttentionConfig
    from .nn.ffn import FFNConfig
    from .optim.optimizers import OptimizerConfig
    V, D, L, B, S = (CHAOS[k] for k in "VDLBS")
    f32 = torch.float32
    mc = LMConfig(name="t", vocab=V, d_model=D, n_layers=L,
                  attn=AttentionConfig(D, 4, 4, 8, dtype=f32),
                  ffn=FFNConfig(D, 2 * D, dtype=f32), dtype=f32)
    acfg = ArchConfig(name="chaos-smoke", family="lm", model=mc,
                      smoke_model=mc, source="chaos", strategy="df")
    cluster = replace(ClusterSpec.of("host"),
                      topology=Torus((2, 2), model_dims=(1,)))
    ses = Oracle(acfg, ShapeSpec("train_tiny", S, B, "train"), cluster,
                 batch=B, seq=S)
    return ses, DataConfig("lm", batch=B, seq_len=S, vocab=V), \
        OptimizerConfig(lr=1e-2, name="adamw", zero1=False)


def _chaos_rank(mesh, device: str) -> str | None:
    """One rank of the chaos smoke (see ``_chaos``); rank 0 returns its
    summary line."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from .checkpoint import Checkpointer
    from .runtime.elastic import (planned_continuation, run_elastic,
                                  whole_params)
    from .runtime.fault_tolerance import SliceLost
    N, KILL, EVERY = CHAOS["N"], CHAOS["KILL"], CHAOS["EVERY"]
    ses, data_cfg, opt = chaos_setup()
    box = [tempfile.mkdtemp(prefix="chaos_") if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, mesh.ranks[0],
                               group=mesh.group(tuple(mesh.shape)).pg)
    root = box[0]

    def run(inject, where):
        traj, meshes = {}, []
        state, step, events = run_elastic(
            ses, data_cfg, Checkpointer(f"{root}/{where}", keep=10,
                                        mesh=mesh),
            n_steps=N, mesh=mesh, device=device, opt=opt, ckpt_every=EVERY,
            inject=inject, seed=0, straggler_patience=None,
            on_bind=lambda b: meshes.append(b.mesh),
            on_metrics=lambda s, m: traj.__setitem__(s, float(m["loss"])))
        if state is None:
            return traj, events, None
        assert step == N, (step, N)
        return traj, events, whole_params(state, meshes[-1])

    fired = set()

    def kill(step):
        if step == KILL and step not in fired:
            fired.add(step)
            raise SliceLost(step, dim=0, reason="injected slice death")

    traj_a, ev_a, _ = run(None, "a")          # uninterrupted baseline
    traj_b, ev_b, params_b = run(kill, "b")   # chaos run
    assert ev_a == [] and len(ev_b) == 1, (ev_a, ev_b)
    ev = ev_b[0]
    p = CHAOS["RANKS"]
    assert (ev.p_before, ev.p_after) == (p, p // 2), ev
    # the re-tuned plan is valid on the shrunken topology
    degraded = ses.cluster.degraded(dim=0)
    assert degraded.topology.size == p // 2
    p1, p2 = ev.mesh_shape
    assert p1 * p2 == p // 2, ev
    assert bool(degraded.topology.split_mask(p // 2, p1, p2, ev.strategy)), ev
    resumed = ev.resumed_from
    assert 0 < resumed <= KILL and resumed % EVERY == 0, ev
    # prefix: bit-exact vs the uninterrupted run (same mesh, same plan)
    for s in range(resumed):
        assert traj_b[s] == traj_a[s], (s, traj_b[s], traj_a[s])
    # suffix: bit-exact vs a PLANNED degraded continuation from the
    # baseline's own checkpoint — recovery ≡ planned reshape
    ref = planned_continuation(
        ses.with_cluster(degraded), mesh, p // 2, data_cfg, opt, N,
        ckpt=Checkpointer(f"{root}/a"), step=resumed, device=device, seed=0)
    line = None
    if ref is not None:
        for s in range(resumed, N):
            assert traj_b[s] == ref["losses"][s], (s, traj_b[s],
                                                   ref["losses"][s])
        for k, v in ref["params"].items():
            assert torch.equal(params_b[k], v), k
        line = (f"repro_torch.api --chaos OK (slice death @ step {KILL}: p "
                f"{p}→{p // 2} on {degraded.topology}, re-tuned "
                f"{ev.strategy} {p1}x{p2}, resumed @ {resumed}; trajectory "
                f"+ final params bit-exact vs planned reshape)")
    # every rank is done with the directory before rank 0 removes it
    dist.barrier(group=mesh.group(tuple(mesh.shape)).pg)
    if mesh.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    return line


def _chaos(device: str) -> int:
    """Chaos smoke (DESIGN.md §12): kill a torus slice mid-run and prove
    the elastic loop end to end — the tuner re-plans on the surviving
    ClusterSpec, the checkpoint restores onto the survivors' mesh, and the
    resumed loss trajectory is bit-exact vs an uninterrupted baseline
    (prefix) and vs a clean continuation planned on the degraded machine
    (suffix), final parameters included: recovery ≡ planned reshape, bit
    for bit.

    Self-contained (no tests/ import): the tiny LM of ``chaos_setup`` on
    4 ranks over gloo on ``device`` (4 ranks for the reference's 8 virtual
    devices), a (2, 2) torus losing dim 0 → a (2)-torus at step 10 of 16.
    The ranks are this process's world where one is initialised (every
    rank calls this), else 4 spawned ones (``launch.spawn.run_ranks``).
    The straggler watch only logs here: a loaded host's slow steps must
    not reshape the run. The richer scenario matrix lives in
    tests/test_torch_chaos.py."""
    import torch.distributed as dist

    from .launch.mesh import make_host_mesh
    from .launch.spawn import run_ranks
    if dist.is_initialized():
        if dist.get_world_size() != CHAOS["RANKS"]:
            raise ValueError(f"the chaos smoke runs on {CHAOS['RANKS']} "
                             f"ranks, the world has "
                             f"{dist.get_world_size()}")
        line = _chaos_rank(make_host_mesh(backend=dist.get_backend(),
                                          device=device), device)
    else:
        line = run_ranks(_chaos_rank, CHAOS["RANKS"], device,
                         backend="gloo", device=device, timeout_s=600)[0]
    if line:
        print(line, flush=True)
    return 0


def _calibrate(out: str | None, device: str) -> int:
    """Fit the one-device ClusterSpec (the smoke ResNet-50's compute rate on
    ``device``, the host's levels) and write it as JSON."""
    import platform

    import torch
    ses = Oracle("resnet50", "train_4k", "host", smoke=True)
    spec = ses.calibrate(None, device=device)
    print(spec.describe())
    print(f"peak_flops (measured) {spec.peak_flops:.6g}")
    if out:
        rec = spec.to_json()
        rec["meta"] = {"harness": "python -m repro_torch.api --calibrate",
                       "device": device, "host": platform.machine(),
                       "torch": torch.__version__}
        rec["measurements"] = [m.to_json() for m in ses.last_measurements]
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out}")
        again = ClusterSpec.from_json(out)
        assert again.peak_flops == spec.peak_flops
    return 0


def _serve_tune(arch: str, p: int, rate: float, prompt: int, gen: int,
                slo_ms: float, max_len: int | None, cluster: str) -> int:
    """Price the serving sweep and print the plan; exit 1 when no
    configuration meets the p99 SLO."""
    from .serve.traffic import TrafficModel
    ses = Oracle(arch, cluster=cluster)   # analytic: the full config
    traffic = TrafficModel(rate=rate, prompt_len=prompt, gen_len=gen)
    plan = ses.serve_tune(traffic, p, slo_ms / 1e3, max_len=max_len)
    print(f"serving sweep: {ses.arch_cfg.name} on {ses.cluster.name}, "
          f"p={p}, rate={rate}/s, prompt={prompt}, gen={gen}")
    print(plan.describe())
    shown = 0
    for row in plan.rows:
        if row is plan.winner or row is plan.runner_up:
            continue
        print("  " + row.describe())
        shown += 1
        if shown >= 8:
            break
    print(f"repro_torch.api --serve-tune "
          f"{'OK' if plan.meets_slo else 'SLO-MISS'}")
    return 0 if plan.meets_slo else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Oracle session facade utilities.")
    ap.add_argument("--smoke", action="store_true",
                    help="project → tune → build, and one step of the "
                         "built cell, on the host cluster")
    ap.add_argument("--parity", action="store_true",
                    help="session ↔ direct-call 1e-12 parity gate")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit a ClusterSpec on one device (its compute)")
    ap.add_argument("--chaos", action="store_true",
                    help="elastic-training chaos smoke: a slice lost on 4 "
                         "ranks, recovery held bit for bit against a "
                         "planned reshape")
    ap.add_argument("--out", default=None,
                    help="--calibrate: the fitted ClusterSpec's JSON")
    ap.add_argument("--device", default="cuda",
                    help="--smoke/--calibrate/--chaos: 'cuda' (default) or "
                         "'cpu'")
    ap.add_argument("--serve-tune", action="store_true",
                    help="price the serving sweep and print the cheapest "
                         "plan meeting --slo-ms; exits 1 on an SLO miss")
    ap.add_argument("--arch", default="qwen1.5-4b",
                    help="--serve-tune arch")
    ap.add_argument("--p", type=int, default=8,
                    help="--serve-tune deployment size (PEs)")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="--serve-tune arrival rate, requests/s")
    ap.add_argument("--prompt", type=int, default=512,
                    help="--serve-tune mean prompt length")
    ap.add_argument("--gen", type=int, default=128,
                    help="--serve-tune generation length")
    ap.add_argument("--slo-ms", type=float, default=30000.0,
                    help="--serve-tune p99 request-latency SLO (ms)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="--serve-tune KV capacity per sequence")
    ap.add_argument("--cluster", default="tpu",
                    help="--serve-tune machine description preset "
                         "(tpu | paper | host | a ClusterSpec JSON path)")
    args = ap.parse_args(argv)
    if args.chaos:
        return _chaos(args.device)
    if args.serve_tune:
        cluster = (ClusterSpec.from_json(args.cluster)
                   if args.cluster.endswith(".json") else args.cluster)
        return _serve_tune(args.arch, args.p, args.rate, args.prompt,
                           args.gen, args.slo_ms, args.max_len, cluster)
    if args.parity:
        return _parity()
    if args.calibrate:
        return _calibrate(args.out, args.device)
    if args.smoke:
        return _smoke(args.device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
