"""Where the time of a training step goes, on one GPU or on one rank of a
sharded CNN step.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch resnet50|resnet152|vgg16|cosmoflow|qwen1.5-4b|mamba2-780m]
        [--strategies data,ds]   (an LM: data,spatial,filter,channel,df,
                                  ds,df_zero1,df_zero3, and summa for the
                                  Qwen)
        [--strategies pipeline --schedule gpipe|one_f_one_b|interleaved]

Builds the CNN at its full config (fp32, TF32 off, random weights from seed
0) and the train step the oracle's validation measures (SGD,
``core.validation.measure_step``), warms up 2 steps, then traces 2 steps
with ``torch.profiler`` (CPU and CUDA activities). The batch is the model's
``configs.cnn_archs.ORACLE_BATCH``, as in ``chip_smoke.py``'s oracle phase.
An LM (bf16, full width) takes the trainer's AdamW step at its
``configs.lm_archs.LM_TRAIN_SHAPE`` (batch, seq), as in ``chip_smoke.py``'s
lm-train phase, on one device; across ranks, the SGD step of the
lm-parallel phase (``LM_PARALLEL_SHAPE``: full widths, 2 layers, fp32),
"summa" on the (1, 2, 2) grid of the summa phase, and "pipeline" at the
lm-pipeline phase's ``LM_PIPELINE_SHAPE`` (cut on the per-layer costs).
Imports nothing of jax or of the JAX package; needs CUDA.

Without ``--strategies``: one process on the card. Prints, as
``profile_serve`` does, the host time, the summed device time of the
kernels, the device's busy share, the number of device events and the ten
kernels with the most device time.

With ``--strategies``: RANKS ranks (``launch.spawn``) share cuda:0 over
gloo on a (RANKS / MODEL_AXIS, MODEL_AXIS) mesh, as ``chip_smoke.py``'s
parallel phase runs them; the batch is global. For each strategy the
sharded model is built and warmed up on every rank, then rank 0 traces its
2 steps while the others run them untraced. Prints per strategy: the host
time of a step, the device time of rank 0's kernels and of its copies (the
host staging of gloo's collectives is device-to-host and host-to-device
copies), the host time inside the collectives (the ``comm.*`` spans of
``parallel/collectives.py`` and ``parallel/halo.py``: staging, transfer and
the wait for the other ranks), and the five kernels with the most device
time. Ranks that share a card compete for it, so rank 0's device time is
its own share.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..configs.cnn_archs import ORACLE_BATCH
from ..configs.lm_archs import (LM_PARALLEL_SHAPE, LM_PIPELINE_SHAPE,
                                LM_TRAIN_SHAPE, lm_parallel_arch)
from ..core.layer_stats import stats_for
from ..data.pipeline import Loader
from ..nn.module import ShardingCtx
from ..optim.optimizers import OptimizerConfig
from ..parallel.schedules import (SCHEDULE_NAMES, make_pipeline_train_step,
                                  pipeline_block_costs)
from ..parallel.strategies import make_rules
from ..training.steps import make_train_step, train_state
from .build import build_model, shard_batch
from .mesh import make_grid_mesh
from .profile_serve import report
from .spawn import run_ranks
from .train import CNN_STRATEGIES, LM_STRATEGIES, data_config_for

STEPS = 2
RANKS, MODEL_AXIS = 4, 2
ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
# spans that are not kernels: the port's ``comm.*`` and the backends'
# own annotations, which the profiler also shows on the device's timeline
_SPANS = ("comm.", "gloo:", "nccl:", "record_param_comms")


def _shape(arch: str, sharded: bool = False, pipe: bool = False) -> str:
    if arch in LM_TRAIN_SHAPE:
        if sharded:
            return "l{}_b{}_s{}_fp32".format(
                *(LM_PIPELINE_SHAPE if pipe else LM_PARALLEL_SHAPE)[arch])
        return "b{}_s{}".format(*LM_TRAIN_SHAPE[arch])
    return f"b{ORACLE_BATCH[arch]}"


def _warm_step(arch: str, ctx: ShardingCtx, schedule: str | None = None,
               zero1: bool = False):
    """The SGD step of CNN ``arch`` at its oracle batch under ``ctx`` (with
    a ``schedule``: the pipeline step over ``ctx.mesh``'s model axis), or
    an LM's AdamW step at its LM_TRAIN_SHAPE (across ranks, its SGD step
    at LM_PARALLEL_SHAPE), after 2 warm-up steps: (step, state, batch)."""
    cfg = get_config(arch)
    if arch in LM_TRAIN_SHAPE and ctx.sharded:
        layers, size, seq = (LM_PIPELINE_SHAPE if schedule else
                             LM_PARALLEL_SHAPE)[arch]
        cfg = lm_parallel_arch(arch, layers)
        opt = OptimizerConfig(name="sgd", zero1=zero1)
        fwd_kw = {"q_chunk": min(256, seq)}
    elif arch in LM_TRAIN_SHAPE:
        size, seq = LM_TRAIN_SHAPE[arch]
        opt, fwd_kw = OptimizerConfig(), {"q_chunk": min(256, seq)}
    else:
        size, seq = ORACLE_BATCH[arch], 0
        opt, fwd_kw = OptimizerConfig(name="sgd"), {}
    batch = Loader(data_config_for(cfg.model, size, seq),
                   ctx.device).batch_at(0)
    if schedule is None:
        model = build_model(cfg, ctx, seed=0)
        if ctx.sharded:
            batch = shard_batch(batch, ctx)
        step = make_train_step(model, opt, ctx, **fwd_kw)
    else:
        model = build_model(cfg, ShardingCtx(ctx.device), seed=0)
        if seq:
            fwd_kw["block_costs"] = pipeline_block_costs(
                model, stats_for(cfg.model, seq))
        step = make_pipeline_train_step(model, opt, ctx, schedule=schedule,
                                        **fwd_kw)
    state = train_state(model, opt, ctx)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize(ctx.device)
    return step, state, batch


def _traced(step, state, batch, device, traced: bool):
    """Runs STEPS steps, under the profiler if ``traced``; (profile or
    None, host seconds)."""
    with (profile(activities=ACTIVITIES) if traced else
          contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize(device)
        return prof, time.perf_counter() - t0


def _summary(prof, host_s: float) -> dict:
    """Per step: rank 0's kernel and copy time on the device, and its host
    time inside each ``comm.*`` span (from the raw events, so a span's
    host and device records are not merged)."""
    kernels, copies, comm = {}, 0.0, {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(_SPANS):
                continue
            if "memcpy" in e.name.lower() or "memset" in e.name.lower():
                copies += us
            else:
                k = kernels.setdefault(e.name, [0.0, 0])
                k[0] += us
                k[1] += 1
        elif e.name.startswith("comm."):
            comm[e.name] = comm.get(e.name, 0.0) + us
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:5]
    return {
        "host_ms": host_s * 1e3 / STEPS,
        "kernel_ms": sum(v[0] for v in kernels.values()) / 1e3 / STEPS,
        "copy_ms": copies / 1e3 / STEPS,
        "comm_host_ms": {k: v / 1e3 / STEPS for k, v in comm.items()},
        "top": [(k[:70], v[0] / 1e3 / STEPS, v[1] // STEPS) for k, v in top],
    }


def _rank(mesh, arch: str, strategies: tuple, schedule: str) -> dict:
    out = {}
    for s in strategies:
        pipe = s == "pipeline"
        grid = (mesh.regrid(1, RANKS) if pipe else
                make_grid_mesh(mesh, 1, 2, RANKS // 2) if s == "summa"
                else mesh)
        ctx = ShardingCtx(mesh.device, mesh=grid, rules=make_rules(s))
        step, state, batch = _warm_step(arch, ctx, schedule if pipe
                                        else None, zero1=s == "df_zero1")
        prof, host_s = _traced(step, state, batch, mesh.device,
                               mesh.rank == 0)
        if mesh.rank == 0:
            out[f"{s}-{schedule}" if pipe else s] = _summary(prof, host_s)
        del step, state, batch
        torch.cuda.empty_cache()
    return out


def _report_sharded(arch: str, res: dict) -> None:
    for s, r in res.items():
        shape = _shape(arch, sharded=True, pipe=s.startswith("pipeline"))
        name = f"{arch}_{shape}_{s}_p{RANKS}"
        comm = sum(r["comm_host_ms"].values())
        print(f"[profile] {name}: host_ms_per_step={r['host_ms']:.6g} "
              f"rank0_kernel_ms={r['kernel_ms']:.6g} "
              f"rank0_copy_ms={r['copy_ms']:.6g} comm_host_ms={comm:.6g} ("
              + " ".join(f"{k}={v:.4g}" for k, v in
                         sorted(r["comm_host_ms"].items())) + ")",
              flush=True)
        for key, ms, n in r["top"]:
            print(f"[profile] {name}   {ms:10.4f} ms x{n:<5d} {key}",
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="cosmoflow",
                    choices=list(ORACLE_BATCH) + list(LM_TRAIN_SHAPE))
    ap.add_argument("--strategies", default=None,
                    help=f"comma-separated rules tables (or pipeline; "
                         f"summa for an attention LM): profile one rank of "
                         f"{RANKS} sharing the card")
    ap.add_argument("--schedule", default="gpipe", choices=SCHEDULE_NAMES,
                    help="the pipeline's schedule")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    if args.strategies:
        known = (LM_STRATEGIES + ("pipeline", "summa")
                 if args.arch in LM_TRAIN_SHAPE else
                 CNN_STRATEGIES + ("pipeline",))
        strategies = tuple(args.strategies.split(","))
        for s in strategies:
            if s not in known:
                raise SystemExit(f"strategy {s!r}: one of {known}")
        _report_sharded(args.arch, run_ranks(
            _rank, RANKS, args.arch, strategies, args.schedule,
            backend="gloo", device="cuda", model=MODEL_AXIS,
            timeout_s=900)[0])
        return
    step, state, batch = _warm_step(args.arch, ShardingCtx("cuda"))
    prof, host_s = _traced(step, state, batch, torch.device("cuda"), True)
    report(f"{args.arch}_{_shape(args.arch)}_train_x{STEPS}", prof, host_s,
           None)


if __name__ == "__main__":
    main()
