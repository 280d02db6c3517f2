"""Where the time of the port's LM serving path goes, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen1.5-4b|mamba2-780m] [--engine] [--trace-dir DIR]

Builds the LM (default Qwen1.5-4B) at full width (bf16, random weights from
seed 0), warms up, then traces one prompt pass (4 prompts of 2048 tokens,
from a zeroed cache) and 4 greedy decode steps with ``torch.profiler`` (CPU
and CUDA activities), with ``use_pallas`` on. Prints, per phase: the host
time, the summed device time of its kernels, the device's busy share
(device time / host time, an upper bound when kernels overlap), the number
of device events (kernels and copies), and the ten with the most device
time, each with its share of the phase's device time; with
``--trace-dir``, also writes the Chrome traces there. Imports nothing of
jax or of the JAX package; needs CUDA.

With ``--engine`` (Qwen1.5-4B; the paged pool serves attention caches
only): the serving engine's cell, ``engine_cell`` (ENGINE_REQUESTS requests
of TrafficModel(**ENGINE_TRAFFIC), seed 0, ServeConfig(**ENGINE_CFG),
max_len as ``launch.serve`` reckons it, the cell chip_smoke.py's engine
phase measures): a warm-up replay and a timed one, then ENGINE_STEPS
engine steps traced in the middle of a third (``_profile_engine``), and
the gather and scatter of one cell timed alone.
"""
from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..nn.module import ShardingCtx, zeros_like_spec
from ..serve import Engine, ServeConfig, TrafficModel
from ..serve import kv_cache as kvc
from ..training.steps import make_decode_step, make_prefill_step
from .build import build_model
from .serve import trace_max_len

B, S, STEPS = 4, 2048, 4
# the serving engine's cell: Qwen1.5-4B behind 16 requests with prompts of
# 128-384 tokens (256 ± 50 %) and 32 generated each, 8 decode slots
ENGINE_TRAFFIC = dict(rate=8.0, prompt_len=256, gen_len=32)
ENGINE_REQUESTS = 16
ENGINE_CFG = dict(max_batch=8, block_tokens=16, prefill_chunk=64)
# --engine traces ENGINE_STEPS engine steps after ENGINE_WARM untraced ones
ENGINE_WARM, ENGINE_STEPS = 16, 8


def _device_us(event) -> float:
    # renamed from cuda_time_total to device_time_total across versions
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def report(name: str, prof, host_s: float, trace_dir: str | None):
    # the device's own events (kernels, copies), not the host ops that
    # launched them, which carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in events) / 1e3
    print(f"[profile] {name}: host_ms={host_s * 1e3:.6g} "
          f"device_ms={device_ms:.6g} "
          f"busy_share={device_ms / (host_s * 1e3):.4g} "
          f"device_events={sum(e.count for e in events)}", flush=True)
    for e in sorted(events, key=_device_us, reverse=True)[:10]:
        share = _device_us(e) / 1e3 / device_ms
        print(f"[profile] {name}   {_device_us(e) / 1e3:10.4f} ms "
              f"{share:6.1%} x{e.count:<5d} {e.key[:90]}", flush=True)
    if trace_dir:
        prof.export_chrome_trace(str(Path(trace_dir) / f"{name}.json"))


def engine_cell(vocab: int):
    """(traffic, trace, ServeConfig) of the engine's cell: seed 0, max_len
    as ``launch.serve`` reckons it from the trace (448)."""
    traffic = TrafficModel(**ENGINE_TRAFFIC)
    trace = traffic.trace(ENGINE_REQUESTS, vocab, seed=0)
    max_len = trace_max_len(trace, ENGINE_CFG["prefill_chunk"],
                            traffic.gen_len)
    return traffic, trace, ServeConfig(max_len=max_len, **ENGINE_CFG)


def _event_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` (CUDA events), after one warm-up."""
    fn()
    pairs = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _profile_engine(model, ctx, trace_dir):
    """One unprofiled replay (its wall clock and summary), then, with every
    request submitted, ENGINE_WARM engine steps untraced (the decode slots
    fill) and ENGINE_STEPS traced: each a prefill chunk and a decode batch.
    Then the dense view's gather and the touched blocks' scatter of one
    decode cell (all rows, every block) and one prefill cell timed alone."""
    _, trace, scfg = engine_cell(model.cfg.vocab)
    eng = Engine(model, ctx, scfg)
    eng.run(trace, honor_arrivals=False)                    # warm-up
    eng.reset()
    rep = eng.run(trace, honor_arrivals=False)
    print(f"[profile] engine replay: {rep.summary()}", flush=True)
    eng.reset()
    for r in trace:
        eng.submit(r)
    for _ in range(ENGINE_WARM):
        eng.step()
    print(f"[profile] engine window: {eng.n_live} live sequences, "
          f"{len(eng.queue)} queued", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ENGINE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    while not eng.idle:
        eng.step()
    report(f"{model.cfg.name}_engine_steps_x{ENGINE_STEPS}", prof, host_s,
           trace_dir)
    geo, dev = eng.geo, ctx.device
    for name, rows, nj in (("decode", scfg.max_batch, 1),
                           ("prefill", 1, scfg.prefill_chunk // geo.bspan)):
        tables = torch.arange(1, rows * geo.n_blk + 1,
                              device=dev).reshape(rows, geo.n_blk)
        jidx = torch.zeros((rows, nj), dtype=torch.long, device=dev)
        dense = kvc.gather_view(eng.pool, tables)
        gather = _event_ms(lambda: kvc.gather_view(eng.pool, tables))
        scatter = _event_ms(lambda: kvc.scatter_blocks(eng.pool, tables,
                                                       dense, jidx))
        print(f"[profile] engine {name} cell: gather_view {gather:.4g} ms, "
              f"scatter_blocks {scatter:.4g} ms of device time ({rows} "
              f"rows x {geo.n_blk} blocks gathered, {nj} a row written)",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b",
                    choices=["qwen1.5-4b", "mamba2-780m"])
    ap.add_argument("--engine", action="store_true",
                    help="profile the serving engine's replay (Qwen only)")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: CUDA is not available")
    if args.trace_dir:
        Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
    ctx = ShardingCtx("cuda", use_pallas=True)
    model = build_model(get_config(args.arch), ctx, seed=0)
    if args.engine:
        return _profile_engine(model, ctx, args.trace_dir)
    tokens = torch.randint(0, model.cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    cache = zeros_like_spec(model.cache_spec(B, S + STEPS), "cuda")
    prefill, decode = make_prefill_step(model, ctx), make_decode_step(model,
                                                                      ctx)
    logits, cache = prefill({"tokens": tokens}, cache)      # warm-up
    decode(logits.argmax(-1), cache, S)
    for layer in cache["blocks"]:   # the SSM's prompt pass reads its state
        for t in layer.values():
            t.zero_()
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = prefill({"tokens": tokens}, cache)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    report(f"{args.arch}_prefill", prof, host_s, args.trace_dir)
    tok = logits.argmax(-1)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(STEPS):
            logits, cache = decode(tok, cache, S + i)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    report(f"{args.arch}_decode_x{STEPS}", prof, host_s, args.trace_dir)


if __name__ == "__main__":
    main()
