"""Single-device training entry point (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \
        --steps 3 --batch 32

Builds the (smoke or full) model with weights drawn from ``--seed``, the
deterministic synthetic loader and the train step, and runs a plain loop on
``--device`` (``cuda`` unless told otherwise; without CUDA it raises). Like
the JAX trainer it trains without ``use_pallas``: the implicit-GEMM kernel
has no backward yet. Checkpointing, ``--strategy auto``, ``--elastic`` and
pipelines come with later slices.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..data.pipeline import DataConfig, Loader
from ..models.cnn import ResNetConfig
from ..nn.module import ShardingCtx
from ..optim.optimizers import OptimizerConfig
from ..training.steps import make_train_step, train_state
from .build import build_model


def data_config_for(mc, batch: int, seed: int = 0) -> DataConfig:
    if isinstance(mc, ResNetConfig):
        return DataConfig("image", batch, image=224, classes=mc.n_classes,
                          seed=seed)
    raise TypeError(f"{type(mc).__name__} is not ported yet")


def main(argv=None) -> dict:
    """Runs the loop; returns the per-step losses and step seconds (each step
    timed from its launch until the device has finished it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; there is no fallback")
    args = ap.parse_args(argv)

    ctx = ShardingCtx(args.device)
    cfg = get_config(args.arch)
    mc = cfg.smoke_model if args.smoke else cfg.model
    model = build_model(cfg, ctx, smoke=args.smoke, seed=args.seed)
    opt = OptimizerConfig(lr=args.lr)
    step = make_train_step(model, opt, ctx, accum=args.accum)
    state = train_state(model, opt)
    loader = Loader(data_config_for(mc, args.batch, args.seed), ctx.device)

    losses, step_s = [], []
    t_start = time.perf_counter()
    for s in range(args.steps):
        batch = loader.batch_at(s)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if s % args.log_every == 0:
            print(f"step {s:5d} loss {losses[-1]:.4f} "
                  f"grad_norm {float(m['grad_norm']):.3f} "
                  f"({time.perf_counter() - t_start:.1f}s)", flush=True)
    if losses:
        print(f"done at step {state['step']}; loss {losses[0]:.4f} → "
              f"{losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s, "device": str(ctx.device)}


if __name__ == "__main__":
    main()
