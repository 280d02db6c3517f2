"""Serving CLI (counterpart of ``repro.launch.serve``): the
continuous-batching engine behind a traffic replay.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --rate 8 --prompt-len 256 --gen 32 --requests 16 --max-batch 8 \\
        --prefill-chunk 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --smoke --device cpu --closed-loop
    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 \\
        -m repro_torch.launch.serve --arch qwen1.5-4b --smoke --device cpu \\
        --closed-loop --strategy serve_seqkv

Thin glue: the engine (``serve/engine.py``) owns the request queue, the
paged KV pool and the prefill and decode cells. This file builds the (smoke
or full) model on ``--device`` (``cuda`` unless told otherwise; without
CUDA it raises) with weights drawn from ``--seed`` and ``use_pallas`` on,
as the reference's serving profile runs it (a kernel's wrapper takes its
plain version only for a tensor on the CPU), generates the trace, replays
it (open-loop against ``--rate``, or ``--closed-loop``) and prints the
report; ``--json-out`` writes it.

Under ``torchrun`` (or a spawner that set its variables and initialised
the world) every rank serves on a (1, n) mesh of the n ranks, as the
reference's ``make_host_mesh(model=n)``: ``--strategy serve_tp`` splits
the weights and the cache's kv heads over them, ``serve_seqkv`` the
weights and the cache's span (``--kv-shards``, by default the mesh's model
size under serve_seqkv and 1 otherwise; ``max_len`` is aligned to
``prefill_chunk·kv_shards``, as the reference aligns it). The transport is
``--backend``: nccl (a card a rank; the default on cuda) or gloo (ranks
sharing a card; the default on the cpu). Rank 0 prints and writes
``--json-out``.

``--strategy auto`` asks the training auto-tuner for the serving layout,
as the reference's does (``resolve_auto_strategy``): the plan for the n
ranks (1 without a world) at ``--max-batch`` and ``--prompt-len`` +
``--gen`` tokens, on the machine the cluster flags describe (``--system``,
default ``host``; ``--cluster`` takes a fitted ``ClusterSpec`` JSON), with
no memory switches and no pipeline; where the winner's model width p2
does not tile n, a warning and a re-tune over the widths that do. Rank 0
prints the plan; it deploys as ``plan.exec_strategy("decode")`` on the
(n / p2, p2) mesh, so a plan with p1 > 1 serves with its decode batch
split over "data" (``serve/engine.py``). A layout the engine cannot serve
raises; nothing falls back.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import torch.distributed as dist

from ..configs import get_config
from ..core.cluster import add_cluster_args
from ..nn.module import ShardingCtx
from ..parallel.strategies import make_rules
from ..serve import Engine, ServeConfig, TrafficModel
from .build import build_model
from .mesh import init_from_env, make_host_mesh

LAYOUTS = ("serve_tp", "serve_seqkv")


def trace_max_len(trace, prefill_chunk: int, gen: int,
                  kv_shards: int = 1) -> int:
    """Per-sequence capacity a trace needs: its longest prompt padded to
    whole prefill chunks, plus the generation, rounded up to a whole
    multiple of ``prefill_chunk·kv_shards`` (each shard's span must be a
    multiple of both the block span and the chunk, and the chunk is a whole
    number of block spans)."""
    longest = max(len(r.prompt) for r in trace)
    need = -(-longest // prefill_chunk) * prefill_chunk + gen
    align = prefill_chunk * kv_shards
    return -(-need // align) * align


def resolve_auto_strategy(mc, args, n: int, log: bool = True):
    """The tuner's serving layout on ``n`` processing elements: (strategy
    name, model width), as the reference's. Re-tunes over the divisors of
    ``n`` when the winner's p2 cannot tile the mesh. ``log``: print the
    plan (rank 0)."""
    from ..core.autotune import autotune, stats_for_model
    from ..core.cluster import ClusterSpec
    from ..core.oracle import TimeModel
    cluster = ClusterSpec.from_cli_args(args)
    stats = stats_for_model(mc, args.prompt_len + args.gen)
    B = args.max_batch
    # no memory switches (no optimizer to shard, no backward to remat) and
    # no pipeline (its schedules are training schedules), as the reference
    kw = dict(fallback="serve_tp", cluster=cluster, switches=None,
              allow_pipeline=False)
    plan = autotune(stats, TimeModel(cluster.system),
                    cluster.oracle_config(B=B, D=B), n, **kw)
    if n % plan.p2:
        tiling = tuple(k for k in range(1, n + 1) if n % k == 0)
        warnings.warn(
            f"tuned model width p2={plan.p2} cannot tile {n} devices; "
            f"re-tuning over widths {tiling} for the best plan that does",
            stacklevel=2)
        plan = autotune(stats, TimeModel(cluster.system),
                        cluster.oracle_config(B=B, D=B), n,
                        model_widths=tiling, **kw)
    if log:
        print(plan.describe(), flush=True)
    return plan.exec_strategy("decode"), plan.p2


def main(argv=None, cfg=None) -> dict:
    """Replays the trace; returns the report's summary with the strategy,
    the mesh and each request's tokens (every rank its own). ``cfg``: an
    ``ArchConfig`` to serve in place of the registry's ``--arch`` (a
    caller's cut of it)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; there is no fallback")
    ap.add_argument("--strategy", default="serve_tp",
                    help="serve_tp | serve_seqkv | 'auto'")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="under torchrun: nccl (one rank per card; the "
                         "default on cuda) or gloo (ranks sharing a card; "
                         "the default on the cpu)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="continuous-batch width (decode slots)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="per-sequence KV capacity "
                         "(default: padded prompt + gen)")
    ap.add_argument("--block-tokens", type=int, default=16,
                    help="paged-cache allocation granularity")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens prefilled per engine step")
    ap.add_argument("--kv-shards", type=int, default=None,
                    help="cache span shards (default: the mesh's model "
                         "size under serve_seqkv, 1 otherwise)")
    # traffic
    ap.add_argument("--rate", type=float, default=8.0,
                    help="request arrival rate (req/s); the trace replays "
                         "open-loop against it")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--closed-loop", action="store_true",
                    help="enqueue the whole trace up front (max-throughput "
                         "mode, ignores arrival times)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="write the report summary as JSON")
    # the machine --strategy auto tunes for (default: this box)
    add_cluster_args(ap, default_system="host")
    args = ap.parse_args(argv)

    cfg = cfg or get_config(args.arch)
    if cfg.family != "lm":
        raise SystemExit(
            f"the serving engine decodes lm archs, not {cfg.family}")
    if args.strategy not in LAYOUTS + ("auto",):
        raise SystemExit(f"--strategy {args.strategy}: the engine serves "
                         f"under {LAYOUTS} or 'auto'")
    world = "WORLD_SIZE" in os.environ
    # a caller that has initialised the world (launch.spawn) keeps it
    own = world and not dist.is_initialized()
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if own:
        init_from_env(backend)
    try:
        strategy, width = args.strategy, dist.get_world_size() if world \
            else 1
        if strategy == "auto":
            mc = cfg.smoke_model if args.smoke else cfg.model
            strategy, width = resolve_auto_strategy(
                mc, args, width, log=not world or dist.get_rank() == 0)
            if strategy not in LAYOUTS:
                raise NotImplementedError(
                    f"the tuned serving layout {strategy} cannot deploy: "
                    f"the engine serves under {LAYOUTS} (expert "
                    f"parallelism needs MoE, ROADMAP queue 1 item 10)")
        if world:
            mesh = make_host_mesh(model=width, backend=backend,
                                  device=args.device)
            ctx = ShardingCtx(mesh.device, use_pallas=True, mesh=mesh,
                              rules=make_rules(strategy))
        else:
            ctx = ShardingCtx(args.device, use_pallas=True)
        return _serve(args, cfg, ctx, strategy)
    finally:
        if own:
            dist.destroy_process_group()


def _serve(args, cfg, ctx: ShardingCtx, strategy: str) -> dict:
    shape = ({"data": ctx.mesh.shape["data"], "model": ctx.mesh.shape[
        "model"]} if ctx.sharded else {"data": 1, "model": 1})
    width = shape["model"]
    log = not ctx.sharded or ctx.mesh.rank == 0
    kv_shards = args.kv_shards if args.kv_shards is not None else (
        width if strategy == "serve_seqkv" else 1)
    model = build_model(cfg, ctx, smoke=args.smoke, seed=args.seed)
    mc = cfg.smoke_model if args.smoke else cfg.model

    traffic = TrafficModel(rate=args.rate, prompt_len=args.prompt_len,
                           gen_len=args.gen)
    trace = traffic.trace(args.requests, mc.vocab, seed=args.seed)
    chunk = args.prefill_chunk
    align = chunk * kv_shards
    max_len = (-(-args.max_len // align) * align if args.max_len
               else trace_max_len(trace, chunk, args.gen, kv_shards))

    scfg = ServeConfig(max_len=max_len, max_batch=args.max_batch,
                       block_tokens=args.block_tokens, prefill_chunk=chunk,
                       kv_shards=kv_shards)
    t0 = time.time()
    eng = Engine(model, ctx, scfg)
    if log:
        print(f"engine up in {time.time() - t0:.1f}s: {eng.geo}, "
              f"{eng.alloc.capacity} blocks, strategy={strategy}, "
              f"mesh={shape}, device={ctx.device}", flush=True)

    report = eng.run(trace, honor_arrivals=not args.closed_loop)
    summary = report.summary()
    out = {"strategy": strategy, "mesh": shape, **summary,
           "tokens_by_request": [r.tokens for r in report.requests]}
    if not log:
        return out
    print(json.dumps(summary, indent=1))
    if report.requests:
        print(f"first request's tokens: {report.requests[0].tokens}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"strategy": strategy, "mesh": shape,
                       "config": {"max_batch": scfg.max_batch,
                                  "max_len": scfg.max_len,
                                  "block_tokens": scfg.block_tokens,
                                  "prefill_chunk": scfg.prefill_chunk,
                                  "kv_shards": scfg.kv_shards},
                       **summary}, f, indent=1)
        print(f"wrote {args.json_out}")
    return out


if __name__ == "__main__":
    main()
