"""Where the time of the port's LM serving path goes, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen1.5-4b|mamba2-780m] [--trace-dir DIR]

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
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..nn.module import ShardingCtx, zeros_like_spec
from ..training.steps import make_decode_step, make_prefill_step
from .build import build_model

B, S, STEPS = 4, 2048, 4


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b",
                    choices=["qwen1.5-4b", "mamba2-780m"])
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: CUDA is not available")
    if args.trace_dir:
        Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
    ctx = ShardingCtx("cuda", use_pallas=True)
    model = build_model(get_config(args.arch), ctx, seed=0)
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
