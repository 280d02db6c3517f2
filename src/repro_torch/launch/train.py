"""Training entry point (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \
        --steps 3 --batch 32
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch resnet50 --steps 3 --batch 32 --strategy ds --backend nccl
    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 \
        -m repro_torch.launch.train --arch resnet50 --smoke --steps 2 \
        --batch 8 --device cpu --strategy pipeline --schedule one_f_one_b

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --steps 3 --batch 2 --seq 512
    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen1.5-4b --smoke --steps 2 \
        --batch 8 --seq 32 --device cpu --strategy df_zero1
    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 \
        -m repro_torch.launch.train --arch mamba2-780m --smoke --steps 2 \
        --batch 8 --seq 32 --device cpu --strategy pipeline
    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 \
        -m repro_torch.launch.train --arch resnet50 --smoke --steps 2 \
        --batch 8 --device cpu --strategy auto

Trains the paper's CNNs (``--arch`` resnet50, resnet152, vgg16 or
cosmoflow) and the LMs (qwen1.5-4b, mamba2-780m; ``--seq`` tokens a
sequence, the forward's query chunk min(256, seq), as the reference's
trainer sets it): builds the (smoke or full) model with weights
drawn from ``--seed``, the deterministic synthetic loader (images, volumes
for CosmoFlow, the bigram token stream for the LMs) and the train step, and
runs a plain loop on ``--device`` (``cuda`` unless told otherwise; without
CUDA it raises). Under every strategy the model and step are one cell of
``launch.build.build_cell``.

Under ``torchrun`` (its WORLD_SIZE in the environment) the ranks form a
(data, model) mesh (``--model`` ranks on the model axis; the reference's
default split otherwise) over ``--backend`` (nccl: one rank per card; gloo:
ranks sharing a card, or the CPU) and train under ``--strategy``, one of the
paper's rule tables (data, spatial, filter, channel, df, ds) or, for an LM,
df with ZeRO-1 (``df_zero1``: the optimizer state split over "data") or
ZeRO-3 (``df_zero3``: the parameters too): every rank draws the whole batch
(``--batch`` is global) and keeps its block. On a card each rank prints its
peak memory at the end. Without a world it is the single-device trainer and
``--strategy`` is moot.

``--strategy pipeline`` is the paper's layer strategy
(``parallel/schedules``): the ranks of the model axis (all of them unless
``--model-axis`` says otherwise) are the stages, ``--schedule`` picks
gpipe, one_f_one_b or interleaved (``--virtual-stages`` chunks a rank),
``--segments`` the requested microbatch count (the step runs the largest
deployable S ≤ it and reports it), and the cuts come from the partitioner
over the oracle's per-block costs (an LM's per-layer costs at ``--seq``;
its embedding runs on the first stage, its head and loss on the last).
``--accum > 1`` is refused there: the microbatches are the accumulation.

``--strategy auto`` lets the oracle decide, as the reference's trainer
does: ``core.autotune`` tunes (strategy, p1 × p2 split, memory switches,
pipeline schedule) for the world's size (1 without a world) on the machine
the cluster flags describe (``--system``, default ``host``; ``--cluster``
takes a fitted ``ClusterSpec`` JSON), at ``--batch`` and ``--seq``; rank 0
prints ``TunedPlan.describe()``. The plan is then deployed: its rules
table (``exec_strategy("train")``) through ``runtime.elastic.bind_plan``,
the one place a plan becomes a mesh and a cell (``Mesh.shrink`` to the
plan's grid: the (data, model_r, model_c) grid for a summa plan), ZeRO-1
from its switch, its remat for an LM (each block under
``torch.utils.checkpoint``), and for a pipeline plan its schedule, segment
count and virtual stages (``--schedule``/``--segments`` given explicitly
override them, as in the reference). A plan the port cannot run raises and
names its ROADMAP queue 1 item (summa on a CNN or an SSM LM: item 8; ep:
item 10); nothing falls back to another strategy. Without a world the
trainer is the single-device one: it prints the p = 1 plan and deploys its
switches.

Like the JAX trainer it trains without ``use_pallas``: none of the four
kernels has a backward, in the JAX package or here, so the convs, norms,
attention and SSD of a training step are their plain versions.

``--ckpt-dir`` checkpoints the train state into ``<ckpt-dir>/<arch>``
(``checkpoint.Checkpointer``: whole leaves, written by rank 0 across
ranks, a config tag of the arch and ``--smoke``) every ``--ckpt-every``
steps (async) and at the end (blocking; skipped when the last async save
holds that step), and a run resumes from the latest
complete step there ("resumed from step k"; "no new steps" when it is
already at ``--steps``): the loader draws batch k for step k, so a resumed
run repeats the straight run's losses bit for bit. Without ``--ckpt-dir``
the trainer writes and resumes nothing (the reference defaults to
``checkpoints``; in the port a default directory would make every run
with the same arch resume the last one's state, across the test suite's
concurrent runs too). The loop runs through
``runtime.fault_tolerance.run_with_recovery``, as the reference's does: with
``--ckpt-dir`` a failing step restores the latest complete checkpoint and
replays; without it a failure raises. Its straggler watch only logs here.

``--elastic`` runs ``runtime.elastic.run_elastic`` on the world's ranks,
as the reference's ``_main_elastic`` does (it needs ``--ckpt-dir``): an
``Oracle`` session on the cluster flags' machine tunes for the ranks and
deploys the plan; on a lost slice, or ``--straggler-patience`` consecutive
straggler alerts, it degrades the ClusterSpec, re-tunes, lays the first p'
ranks out as the new plan's mesh, restores the checkpoint onto it and
resumes. A rank left out returns with its state released and joins no
collective after that: its peak memory is its own, the survivors gather
theirs over the final mesh. ``--strategy``,
``--model-axis`` and the pipeline flags do not apply: the plan decides,
and a pipeline plan is barred.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer, config_hash
from ..configs import get_config
from ..configs.base import ShapeSpec
from ..core.autotune import TunedPlan, autotune, stats_for_model
from ..core.cluster import ClusterSpec, add_cluster_args
from ..core.oracle import TimeModel
from ..data.pipeline import DataConfig
from ..models.cnn import CosmoFlowConfig, ResNetConfig, VGGConfig
from ..models.transformer import LMConfig
from ..nn.module import resolve_device
from ..optim.optimizers import OptimizerConfig
from ..parallel.schedules import (SCHEDULE_NAMES, gather_pipeline_state,
                                  pipeline_block_count, pipeline_supported)
from ..parallel.summa import summa_supported
from ..runtime.fault_tolerance import run_with_recovery
from ..training.steps import train_state
from .build import CellLoader, build_cell
from .mesh import init_from_env, make_host_mesh

# the rule tables the CNNs run under, and the LMs (the others raise)
CNN_STRATEGIES = ("data", "spatial", "filter", "channel", "df", "ds")
LM_STRATEGIES = CNN_STRATEGIES + ("df_zero1", "df_zero3")


def data_config_for(mc, batch: int, seq: int = 128,
                    seed: int = 0) -> DataConfig:
    """The data config of model config ``mc`` (``seq`` is read by LMs
    only)."""
    if isinstance(mc, LMConfig):
        return DataConfig("lm", batch, seq_len=seq, vocab=mc.vocab, seed=seed)
    if isinstance(mc, (ResNetConfig, VGGConfig)):
        return DataConfig("image", batch, image=getattr(mc, "img", 224),
                          classes=mc.n_classes, seed=seed)
    if isinstance(mc, CosmoFlowConfig):
        return DataConfig("volume", batch, image=mc.img, channels=mc.in_ch,
                          n_targets=mc.n_targets, seed=seed)
    raise TypeError(f"{type(mc).__name__} is not ported yet")


def main(argv=None, cfg=None) -> dict:
    """Runs the loop; returns the per-step losses and step seconds (each step
    timed from its launch until the device has finished it), the strategy
    run, under ``--strategy auto`` the plan, the first step run and the
    checkpoints saved. ``cfg``: an ``ArchConfig`` to train in place of the
    registry's ``--arch`` (a caller's cut of it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="tokens a sequence (LMs)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; there is no fallback")
    ap.add_argument("--strategy", default="df",
                    choices=LM_STRATEGIES + ("pipeline", "auto"),
                    help="rules table, or 'pipeline', under torchrun (moot "
                         "on one device); 'auto' lets the oracle's "
                         "auto-tuner pick strategy, mesh and switches")
    ap.add_argument("--schedule", default="auto",
                    choices=SCHEDULE_NAMES + ("auto",),
                    help="pipeline schedule; 'auto' follows the tuned plan "
                         "(--strategy auto) or gpipe otherwise")
    ap.add_argument("--segments", type=int, default=None,
                    help="requested microbatch count S of the pipeline "
                         "(default: the tuned plan's, else 8)")
    ap.add_argument("--virtual-stages", type=int, default=2,
                    help="v of the interleaved schedule (chunks per rank)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="under torchrun: nccl (one rank per card; the "
                         "default on cuda) or gloo (ranks sharing a card; "
                         "the default on the cpu)")
    ap.add_argument("--model-axis", type=int, default=None,
                    help="ranks on the mesh's model axis (the pipeline's "
                         "stages; default: all ranks under pipeline; the "
                         "plan's p2 under auto)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint into (and resume from) "
                         "<ckpt-dir>/<arch>; none without it")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between async checkpoints (and one at the "
                         "end)")
    ap.add_argument("--elastic", action="store_true",
                    help="oracle-guided elastic loop (runtime/elastic.py): "
                         "tune for the ranks; on slice loss or repeated "
                         "stragglers re-tune on the surviving ClusterSpec, "
                         "restore the checkpoint onto the survivors and "
                         "resume (needs --ckpt-dir)")
    ap.add_argument("--straggler-patience", type=int, default=3,
                    help="--elastic: consecutive straggler alerts before "
                         "the loop checkpoints and re-meshes around the "
                         "slow host")
    # the machine --strategy auto tunes for (default: this box)
    add_cluster_args(ap, default_system="host")
    args = ap.parse_args(argv)
    args.cfg = cfg or get_config(args.arch)
    if args.elastic and not args.ckpt_dir:
        raise SystemExit("--elastic restores from checkpoints: give it "
                         "--ckpt-dir")

    world = "WORLD_SIZE" in os.environ
    # a caller that has initialised the world (launch.spawn) keeps it
    own = world and not dist.is_initialized()
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if own:
        init_from_env(backend)
    try:
        # the trainer starts on the whole world; only run_elastic's
        # shrunk meshes cover less (they use mesh.size and mesh.rank)
        if args.elastic:
            return _elastic(args, make_host_mesh(
                backend=backend, device=args.device) if world else None)
        plan = None
        if args.strategy == "auto":
            plan = tune(args, dist.get_world_size() if world else 1)
            if not world or dist.get_rank() == 0:
                print(plan.describe(), flush=True)
            deployable(plan, args.cfg.smoke_model if args.smoke
                       else args.cfg.model)
        strategy = plan.exec_strategy("train") if plan else args.strategy
        if strategy == "pipeline" and args.accum != 1:
            raise SystemExit("--accum > 1 is not supported with --strategy "
                             "pipeline (the pipeline microbatches are the "
                             "accumulation schedule)")
        mesh = None
        if world and plan is not None:
            mesh = make_host_mesh(model=plan.p2, backend=backend,
                                  device=args.device)
        elif world:
            model_axis = args.model_axis
            if strategy == "pipeline" and model_axis is None:
                model_axis = dist.get_world_size()
            mesh = make_host_mesh(model=model_axis, backend=backend,
                                  device=args.device)
        return _loop(args, mesh, strategy, plan)
    finally:
        if own:
            dist.destroy_process_group()


def tune(args, n: int) -> TunedPlan:
    """The reference trainer's ``--strategy auto`` tuning on ``n``
    processing elements: one epoch of exactly ``--batch`` samples, at
    ``--seq`` for an LM, on the machine the cluster flags describe."""
    cfg = args.cfg
    mc = cfg.smoke_model if args.smoke else cfg.model
    cluster = ClusterSpec.from_cli_args(args)
    return autotune(stats_for_model(mc, args.seq), TimeModel(cluster.system),
                    cluster.oracle_config(
                        B=args.batch, D=args.batch,
                        virtual_stages=max(args.virtual_stages, 1)), n,
                    schedules=("all" if args.schedule == "auto"
                               else (args.schedule,)),
                    fallback=cfg.strategy, cluster=cluster,
                    allow_remat=cfg.family != "cnn",
                    allow_pipeline=pipeline_supported(mc) is None,
                    max_stages=pipeline_block_count(mc))


def deployable(plan: TunedPlan, mc) -> None:
    """Raises, naming the ROADMAP queue 1 item, for a plan the port cannot
    run on model config ``mc``; never picks another strategy."""
    if plan.strategy == "summa" and summa_supported(mc) is not None:
        raise NotImplementedError(f"the tuned plan {plan.describe()} cannot "
                                  f"deploy: {summa_supported(mc)}")
    if plan.strategy == "ep":
        raise NotImplementedError(
            f"the tuned plan {plan.describe()} cannot deploy: expert "
            f"parallelism (ep_df) needs MoE, ROADMAP queue 1 item 10")


def _loop(args, mesh, strategy: str, plan: TunedPlan | None) -> dict:
    log = mesh is None or mesh.rank == 0
    cfg = args.cfg
    mc = cfg.smoke_model if args.smoke else cfg.model
    # the plan's tables run on any model that reaches here (deployable);
    # by hand the CNNs take the paper's six
    if mesh is not None and plan is None and strategy != "pipeline" and \
            strategy not in (LM_STRATEGIES if isinstance(mc, LMConfig)
                             else CNN_STRATEGIES):
        raise SystemExit(f"--strategy {strategy}: the CNNs run under "
                         f"{CNN_STRATEGIES}, the LMs under {LM_STRATEGIES}")
    # every cell is assembled by build_cell, as in the reference; a plan's
    # schedule, segments and virtual stages give way to --schedule and
    # --segments given explicitly
    shape = ShapeSpec("train_cli", args.seq, args.batch, "train")
    data_cfg = data_config_for(mc, args.batch, args.seq, args.seed)
    schedule = None if args.schedule == "auto" else args.schedule
    if plan is not None:
        # deployed as run_elastic deploys its plans
        from ..api import Oracle
        from ..runtime.elastic import bind_plan
        ses = Oracle(cfg, shape, ClusterSpec.from_cli_args(args),
                     smoke=args.smoke, batch=args.batch, seq=args.seq)
        b = bind_plan(ses, mesh, 1 if mesh is None else mesh.size, data_cfg,
                      OptimizerConfig(lr=args.lr), plan=plan,
                      device=args.device, seed=args.seed, cell_kw=dict(
                          q_chunk=min(256, args.seq), accum=args.accum,
                          segments=args.segments, schedule=schedule))
        cell, state, loader = b.cell, b.state, b.loader
    else:
        # on one device the strategy is moot: the single-device step (a
        # pipeline's one stage holds the whole model)
        cell = build_cell(
            cfg, shape, mesh, strategy if mesh is not None else "data",
            smoke=args.smoke, q_chunk=min(256, args.seq),
            opt=OptimizerConfig(lr=args.lr, zero1="zero1" in strategy),
            accum=args.accum, segments=args.segments, schedule=schedule,
            virtual_stages=args.virtual_stages, device=args.device,
            seed=args.seed)
        state = train_state(cell.model, cell.meta["opt"], cell.ctx)
        loader = CellLoader(cell, data_cfg)
    step, ctx = cell.step_fn, cell.ctx
    pipe = "pipeline" in cell.meta
    if pipe and log:
        _print_pipeline(step, **cell.meta["pipeline"])
    ckpt, start = None, 0
    if args.ckpt_dir:
        where, kw = f"{args.ckpt_dir}/{args.arch}", dict(
            config_tag=config_hash((args.arch, args.smoke)),
            mesh=ctx.mesh if ctx.sharded else None)
        ckpt = _StageCheckpointer(step, where, **kw) if pipe \
            else Checkpointer(where, **kw)
        start = ckpt.latest_step() or 0
        if start:
            state, start = ckpt.restore(state)
            if log:
                print(f"resumed from step {start}", flush=True)

    if ctx.sharded and log:
        print(f"mesh {ctx.mesh} strategy {strategy}", flush=True)
    losses, step_s, on_metrics = _recorder(args, log)
    state, final = run_with_recovery(
        step, state, loader, ckpt, n_steps=args.steps, start_step=start,
        ckpt_every=args.ckpt_every, on_metrics=on_metrics)
    _print_done(losses, final, log)
    out = {"losses": losses, "step_s": step_s, "device": str(ctx.device),
           "strategy": strategy, "plan": plan, "start_step": start,
           "mesh": dict(ctx.mesh.shape) if ctx.sharded else None,
           "ckpt_saves": ckpt.saves if ckpt is not None else []}
    if ctx.device.type == "cuda":
        out["peak_bytes"] = _peaks(ctx.device, ctx.mesh if ctx.sharded
                                   else None, log)
    return out


def _elastic(args, mesh) -> dict:
    """``--elastic``: ``run_elastic`` on ``mesh``'s ranks (None: one
    process), from the latest checkpoint in ``<ckpt-dir>/<arch>``; the
    result dict as ``_loop``'s, with the elastic events, the final plan,
    and None for the strategy and mesh on a rank left out."""
    from ..api import Oracle
    from ..runtime.elastic import run_elastic
    log = mesh is None or mesh.rank == 0
    cfg = args.cfg
    mc = cfg.smoke_model if args.smoke else cfg.model
    ses = Oracle(cfg, "train_4k", ClusterSpec.from_cli_args(args),
                 smoke=args.smoke, batch=args.batch, seq=args.seq)
    ckpt = Checkpointer(f"{args.ckpt_dir}/{args.arch}",
                        config_tag=config_hash((args.arch, args.smoke)),
                        mesh=mesh)
    start = ckpt.latest_step() or 0
    if start and log:
        print(f"resumed from step {start}", flush=True)
    plans = []

    def on_bind(b):
        plans.append((b.plan, b.mesh))
        if b.mesh is None or b.mesh.rank == 0:
            print(b.plan.describe(), flush=True)
    losses, step_s, on_metrics = _recorder(args, log)
    state, final, events = run_elastic(
        ses, data_config_for(mc, args.batch, args.seq, args.seed), ckpt,
        n_steps=args.steps, mesh=mesh, device=args.device,
        opt=OptimizerConfig(lr=args.lr),   # ZeRO-1 follows each plan
        ckpt_every=args.ckpt_every, seed=args.seed,
        straggler_patience=args.straggler_patience, on_metrics=on_metrics,
        on_bind=on_bind, cell_kw=dict(q_chunk=min(256, args.seq)))
    for ev in events:
        if log:
            print(f"elastic event @ step {ev.step}: {ev.cause}, "
                  f"p {ev.p_before}→{ev.p_after}, re-tuned {ev.strategy} "
                  f"(mesh {ev.mesh_shape[0]}x{ev.mesh_shape[1]}), resumed "
                  f"from step {ev.resumed_from}", flush=True)
    live = state is not None
    plan, cell_mesh = plans[-1] if plans else (None, None)
    if live:
        _print_done(losses, final, log)
    out = {"losses": losses, "step_s": step_s,
           "device": str(mesh.device if mesh is not None
                         else resolve_device(args.device)),
           "strategy": plan.exec_strategy("train") if live else None,
           "plan": plan if live else None, "start_step": start,
           "mesh": dict(cell_mesh.shape) if live and cell_mesh is not None
           and cell_mesh.size > 1 else None,
           "ckpt_saves": ckpt.saves, "events": events}
    if torch.device(args.device).type == "cuda":
        # over the final mesh's ranks; a rank left out joins no collective
        # after its return (the world's timeout need not cover the
        # survivors' remaining steps) and reports its own peak
        out["peak_bytes"] = _peaks(resolve_device(args.device)
                                   if mesh is None else mesh.device,
                                   cell_mesh if live else None, log)
    return out


def _recorder(args, log: bool):
    """The losses and step seconds lists and the ``on_metrics`` that fills
    them and prints every ``--log-every`` steps."""
    losses, step_s = [], []
    t_start = time.perf_counter()

    def on_metrics(s, m):
        step_s.append(m["step_s"])
        losses.append(float(m["loss"]))
        if s % args.log_every == 0 and log:
            print(f"step {s:5d} loss {losses[-1]:.4f} "
                  f"grad_norm {float(m['grad_norm']):.3f} "
                  f"({time.perf_counter() - t_start:.1f}s)", flush=True)
    return losses, step_s, on_metrics


def _print_done(losses, final: int, log: bool) -> None:
    if losses and log:
        print(f"done at step {final}; loss {losses[0]:.4f} → "
              f"{losses[-1]:.4f}", flush=True)
    elif log:     # resumed at or past --steps: no new steps this run
        print(f"done at step {final}; no new steps "
              f"(checkpoint already at --steps)", flush=True)


def _print_pipeline(step, schedule: str, segments: int,
                    virtual_stages: int):
    print(f"pipeline schedule={schedule}"
          + (f" v={virtual_stages}" if schedule == "interleaved" else "")
          + f" segments<={segments} cuts={step.bounds}", flush=True)


class _StageCheckpointer(Checkpointer):
    """A pipeline's store: before each save the stages hand every rank the
    blocks they own (``gather_pipeline_state`` with ``pipe_step``, the
    step that holds the cuts)."""

    def __init__(self, pipe_step, *args, **kw):
        super().__init__(*args, **kw)
        self.pipe_step = pipe_step

    def save(self, state, step: int, blocking: bool = True):
        gather_pipeline_state(state, self.pipe_step)
        return super().save(state, step, blocking)


def _peaks(device: torch.device, mesh, log: bool) -> list[int]:
    """Every rank's ``max_memory_allocated`` on ``device``, in rank order
    (one all-gather over ``mesh``'s ranks), printed by rank 0."""
    peak = torch.cuda.max_memory_allocated(device)
    peaks = [peak]
    if mesh is not None and mesh.size > 1:
        mine = torch.tensor([peak], dtype=torch.int64,
                            device=mesh.host_device)
        parts = [torch.empty_like(mine) for _ in range(mesh.size)]
        dist.all_gather(parts, mine, group=mesh.group(tuple(mesh.shape)).pg)
        peaks = [int(t) for t in parts]
    if log:
        print(f"peak memory per rank (max_memory_allocated): "
              f"{[f'{b / 2**30:.4g} GiB' for b in peaks]}", flush=True)
    return peaks


if __name__ == "__main__":
    main()
