"""Serving CLI (counterpart of ``repro.launch.serve``): the
continuous-batching engine behind a traffic replay.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --rate 8 --prompt-len 256 --gen 32 --requests 16 --max-batch 8 \\
        --prefill-chunk 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --smoke --device cpu --closed-loop

Thin glue: the engine (``serve/engine.py``) owns the request queue, the
paged KV pool and the prefill and decode cells. This file builds the (smoke
or full) model on ``--device`` (``cuda`` unless told otherwise; without
CUDA it raises) with weights drawn from ``--seed`` and ``use_pallas`` on,
as the reference's serving profile runs it (a kernel's wrapper takes its
plain version only for a tensor on the CPU), generates the trace, replays
it (open-loop against ``--rate``, or ``--closed-loop``) and prints the
report; ``--json-out`` writes it.

One device, ``serve_tp`` at width 1, is the only layout the port serves:
``--strategy serve_seqkv``, ``--kv-shards`` above 1 and a ``torchrun``
world raise (the sharded serving layouts are ROADMAP queue 1 item 6), and
``--strategy auto`` raises (the auto-tuner and the cluster flags that
describe the machine it tunes for are item 7).
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..configs import get_config
from ..nn.module import ShardingCtx
from ..serve import Engine, ServeConfig, TrafficModel
from .build import build_model


def trace_max_len(trace, prefill_chunk: int, gen: int) -> int:
    """Per-sequence capacity a trace needs: its longest prompt padded to
    whole prefill chunks, plus the generation, rounded up to a whole chunk
    (the cache span must be a multiple of both the block span and the
    chunk, and the chunk is a whole number of block spans)."""
    longest = max(len(r.prompt) for r in trace)
    need = -(-longest // prefill_chunk) * prefill_chunk + gen
    return -(-need // prefill_chunk) * prefill_chunk


def main(argv=None) -> dict:
    """Replays the trace; returns the report's summary."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; there is no fallback")
    ap.add_argument("--strategy", default="serve_tp",
                    help="serve_tp (the one layout on one device) | "
                         "serve_seqkv | 'auto'")
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
                    help="cache span shards (1, the default, on one device)")
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
    kv_shards = 1 if args.kv_shards is None else args.kv_shards
    if args.strategy != "serve_tp" or kv_shards != 1 or \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"--strategy {args.strategy} with --kv-shards {kv_shards} on "
            f"{os.environ.get('WORLD_SIZE', '1')} rank(s): the port serves "
            f"serve_tp on one device; the sharded serving layouts are "
            f"ROADMAP queue 1 item 6")
    ctx = ShardingCtx(args.device, use_pallas=True)
    model = build_model(cfg, ctx, smoke=args.smoke, seed=args.seed)
    mc = cfg.smoke_model if args.smoke else cfg.model

    traffic = TrafficModel(rate=args.rate, prompt_len=args.prompt_len,
                           gen_len=args.gen)
    trace = traffic.trace(args.requests, mc.vocab, seed=args.seed)
    chunk = args.prefill_chunk
    max_len = (-(-args.max_len // chunk) * chunk if args.max_len
               else trace_max_len(trace, chunk, args.gen))

    scfg = ServeConfig(max_len=max_len, max_batch=args.max_batch,
                       block_tokens=args.block_tokens, prefill_chunk=chunk,
                       kv_shards=kv_shards)
    t0 = time.time()
    eng = Engine(model, ctx, scfg)
    print(f"engine up in {time.time() - t0:.1f}s: {eng.geo}, "
          f"{eng.alloc.capacity} blocks, strategy={args.strategy}, "
          f"device={ctx.device}", flush=True)

    report = eng.run(trace, honor_arrivals=not args.closed_loop)
    summary = report.summary()
    print(json.dumps(summary, indent=1))
    if report.requests:
        print(f"first request's tokens: {report.requests[0].tokens}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"strategy": args.strategy,
                       "mesh": {"data": 1, "model": 1},
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
