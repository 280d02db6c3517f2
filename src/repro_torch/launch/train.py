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
CUDA it raises).

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
table (``exec_strategy("train")``) on the mesh ``launch.mesh.mesh_for_plan``
shapes (the (data, model_r, model_c) grid for a summa plan), ZeRO-1 from
its switch, its remat for an LM (each block under
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
Checkpointing and ``--elastic`` are not ported (ROADMAP queue 1 items 7
and 9).
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..configs import get_config
from ..core.autotune import TunedPlan, autotune, stats_for_model
from ..core.cluster import ClusterSpec, add_cluster_args
from ..core.layer_stats import stats_for
from ..core.oracle import TimeModel
from ..data.pipeline import DataConfig, Loader
from ..models.cnn import CosmoFlowConfig, ResNetConfig, VGGConfig
from ..models.transformer import LMConfig
from ..nn.module import ShardingCtx
from ..optim.optimizers import OptimizerConfig
from ..parallel.schedules import (SCHEDULE_NAMES, make_pipeline_train_step,
                                  pipeline_block_costs, pipeline_block_count,
                                  pipeline_supported)
from ..parallel.strategies import make_rules
from ..parallel.summa import summa_supported
from ..training.steps import make_train_step, train_state
from .build import build_model, shard_batch
from .mesh import init_from_env, make_host_mesh, mesh_for_plan

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


def main(argv=None) -> dict:
    """Runs the loop; returns the per-step losses and step seconds (each step
    timed from its launch until the device has finished it), the strategy
    run and, under ``--strategy auto``, the plan."""
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
    # the machine --strategy auto tunes for (default: this box)
    add_cluster_args(ap, default_system="host")
    args = ap.parse_args(argv)

    world = "WORLD_SIZE" in os.environ
    # a caller that has initialised the world (launch.spawn) keeps it
    own = world and not dist.is_initialized()
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if own:
        init_from_env(backend)
    try:
        plan = None
        if args.strategy == "auto":
            plan = tune(args, dist.get_world_size() if world else 1)
            if not world or dist.get_rank() == 0:
                print(plan.describe(), flush=True)
            cfg = get_config(args.arch)
            deployable(plan, cfg.smoke_model if args.smoke else cfg.model)
        strategy = plan.exec_strategy("train") if plan else args.strategy
        if strategy == "pipeline" and args.accum != 1:
            raise SystemExit("--accum > 1 is not supported with --strategy "
                             "pipeline (the pipeline microbatches are the "
                             "accumulation schedule)")
        if world:
            if plan is not None:
                mesh = mesh_for_plan(plan, backend=backend,
                                     device=args.device)
            else:
                model_axis = args.model_axis
                if strategy == "pipeline" and model_axis is None:
                    model_axis = dist.get_world_size()
                mesh = make_host_mesh(model=model_axis, backend=backend,
                                      device=args.device)
            ctx = ShardingCtx(mesh.device, mesh=mesh,
                              rules=make_rules(strategy))
        else:
            ctx = ShardingCtx(args.device)
        return _loop(args, ctx, strategy, plan)
    finally:
        if own:
            dist.destroy_process_group()


def tune(args, n: int) -> TunedPlan:
    """The reference trainer's ``--strategy auto`` tuning on ``n``
    processing elements: one epoch of exactly ``--batch`` samples, at
    ``--seq`` for an LM, on the machine the cluster flags describe."""
    cfg = get_config(args.arch)
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


def _loop(args, ctx: ShardingCtx, strategy: str,
          plan: TunedPlan | None) -> dict:
    log = not ctx.sharded or ctx.mesh.rank == 0
    cfg = get_config(args.arch)
    mc = cfg.smoke_model if args.smoke else cfg.model
    pipe = ctx.sharded and strategy == "pipeline"
    # the plan's tables run on any model that reaches here (deployable);
    # by hand the CNNs take the paper's six
    if ctx.sharded and not pipe and plan is None and strategy not in (
            LM_STRATEGIES if isinstance(mc, LMConfig) else CNN_STRATEGIES):
        raise SystemExit(f"--strategy {strategy}: the CNNs run under "
                         f"{CNN_STRATEGIES}, the LMs under {LM_STRATEGIES}")
    zero1 = plan.zero1 if plan is not None else "zero1" in strategy
    opt = OptimizerConfig(lr=args.lr, zero1=zero1)
    if pipe:
        # every rank holds the whole model and updates the blocks it owns
        model = build_model(cfg, ShardingCtx(ctx.device), smoke=args.smoke,
                            seed=args.seed)
        segments = args.segments or (plan.segments if plan else 8)
        schedule, virtual = args.schedule, args.virtual_stages
        if plan is not None:
            schedule = plan.schedule if schedule == "auto" else schedule
            virtual = plan.virtual_stages
        elif schedule == "auto":
            schedule = "gpipe"
        lm = {}
        if isinstance(mc, LMConfig):
            lm = dict(block_costs=pipeline_block_costs(
                model, stats_for(mc, args.seq)), q_chunk=min(256, args.seq))
        step = make_pipeline_train_step(
            model, opt, ctx, segments=segments, schedule=schedule,
            virtual_stages=virtual, **lm)
        if log:
            print(f"pipeline schedule={schedule}"
                  + (f" v={virtual}" if schedule == "interleaved" else "")
                  + f" segments<={segments} cuts={step.bounds}", flush=True)
    else:
        model = build_model(cfg, ctx, smoke=args.smoke, seed=args.seed)
        fwd_kw = ({"q_chunk": min(256, args.seq)} if cfg.family == "lm"
                  else {})
        if plan is not None and cfg.family == "lm":
            fwd_kw["remat"] = plan.remat   # deploy the plan's remat switch
        step = make_train_step(model, opt, ctx, accum=args.accum, **fwd_kw)
    state = train_state(model, opt, ctx)
    loader = Loader(data_config_for(mc, args.batch, args.seq, args.seed),
                    ctx.device)

    losses, step_s = [], []
    t_start = time.perf_counter()
    if ctx.sharded and log:
        print(f"mesh {ctx.mesh} strategy {strategy}", flush=True)
    for s in range(args.steps):
        batch = loader.batch_at(s)
        if not pipe:
            batch = shard_batch(batch, ctx)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if s % args.log_every == 0 and log:
            print(f"step {s:5d} loss {losses[-1]:.4f} "
                  f"grad_norm {float(m['grad_norm']):.3f} "
                  f"({time.perf_counter() - t_start:.1f}s)", flush=True)
    if losses and log:
        print(f"done at step {state['step']}; loss {losses[0]:.4f} → "
              f"{losses[-1]:.4f}")
    out = {"losses": losses, "step_s": step_s, "device": str(ctx.device),
           "strategy": strategy, "plan": plan,
           "mesh": dict(ctx.mesh.shape) if ctx.sharded else None}
    if ctx.device.type == "cuda":
        out["peak_bytes"] = _peaks(ctx)
        if log:
            print(f"peak memory per rank (max_memory_allocated): "
                  f"{[f'{b / 2**30:.4g} GiB' for b in out['peak_bytes']]}",
                  flush=True)
    return out


def _peaks(ctx: ShardingCtx) -> list[int]:
    """Every rank's ``max_memory_allocated``, in rank order."""
    peak = torch.cuda.max_memory_allocated(ctx.device)
    if not ctx.sharded:
        return [peak]
    mine = torch.tensor([peak], dtype=torch.int64,
                        device=ctx.mesh.host_device)
    parts = [torch.empty_like(mine) for _ in range(ctx.mesh.size)]
    dist.all_gather(parts, mine)
    return [int(t) for t in parts]


if __name__ == "__main__":
    main()
