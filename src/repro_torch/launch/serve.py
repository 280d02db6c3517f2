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
weights and the cache's span (``--kv-shards``, by default n under
serve_seqkv and 1 otherwise; ``max_len`` is aligned to
``prefill_chunk·kv_shards``, as the reference aligns it). The transport is
``--backend``: nccl (a card a rank; the default on cuda) or gloo (ranks
sharing a card; the default on the cpu). Rank 0 prints and writes
``--json-out``. ``--strategy auto`` raises: the auto-tuner and the cluster
flags that describe the machine it tunes for are ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch.distributed as dist

from ..configs import get_config
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


def main(argv=None) -> dict:
    """Replays the trace; returns the report's summary (every rank its
    own)."""
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family != "lm":
        raise SystemExit(
            f"the serving engine decodes lm archs, not {cfg.family}")
    if args.strategy == "auto":
        raise NotImplementedError(
            "--strategy auto needs the oracle's auto-tuner (core/autotune), "
            "ROADMAP queue 1 item 7")
    if args.strategy not in LAYOUTS:
        raise SystemExit(f"--strategy {args.strategy}: the engine serves "
                         f"under {LAYOUTS}")
    world = "WORLD_SIZE" in os.environ
    # a caller that has initialised the world (launch.spawn) keeps it
    own = world and not dist.is_initialized()
    if world:
        backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
        if own:
            init_from_env(backend)
        mesh = make_host_mesh(model=dist.get_world_size(), backend=backend,
                              device=args.device)
        ctx = ShardingCtx(mesh.device, use_pallas=True, mesh=mesh,
                          rules=make_rules(args.strategy))
    else:
        ctx = ShardingCtx(args.device, use_pallas=True)
    try:
        return _serve(args, cfg, ctx)
    finally:
        if own:
            dist.destroy_process_group()


def _serve(args, cfg, ctx: ShardingCtx) -> dict:
    width = ctx.mesh.shape["model"] if ctx.sharded else 1
    log = not ctx.sharded or ctx.mesh.rank == 0
    kv_shards = args.kv_shards if args.kv_shards is not None else (
        width if args.strategy == "serve_seqkv" else 1)
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
              f"{eng.alloc.capacity} blocks, strategy={args.strategy}, "
              f"mesh={{'data': 1, 'model': {width}}}, device={ctx.device}",
              flush=True)

    report = eng.run(trace, honor_arrivals=not args.closed_loop)
    summary = report.summary()
    if not log:
        return summary
    print(json.dumps(summary, indent=1))
    if report.requests:
        print(f"first request's tokens: {report.requests[0].tokens}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"strategy": args.strategy,
                       "mesh": {"data": 1, "model": width},
                       "config": {"max_batch": scfg.max_batch,
                                  "max_len": scfg.max_len,
                                  "block_tokens": scfg.block_tokens,
                                  "prefill_chunk": scfg.prefill_chunk,
                                  "kv_shards": scfg.kv_shards},
                       **summary}, f, indent=1)
        print(f"wrote {args.json_out}")
    return summary


if __name__ == "__main__":
    main()
