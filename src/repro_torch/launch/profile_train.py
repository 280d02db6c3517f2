"""Where the time of a CNN training step goes, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch resnet50|resnet152|vgg16|cosmoflow]

Builds the CNN at its full config (fp32, TF32 off, random weights from seed
0) and the train step the oracle's validation measures (SGD,
``core.validation.measure_step``), warms up 2 steps, then traces 2 steps
with ``torch.profiler`` (CPU and CUDA activities). Prints, as
``profile_serve`` does: the host time, the summed device time of the
kernels, the device's busy share, the number of device events and the ten
kernels with the most device time. The batch is the model's
``configs.cnn_archs.ORACLE_BATCH``, as in ``chip_smoke.py``'s oracle phase.
Imports nothing of jax or of the JAX package; needs CUDA.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..configs.cnn_archs import ORACLE_BATCH
from ..data.pipeline import Loader
from ..nn.module import ShardingCtx
from ..optim.optimizers import OptimizerConfig
from ..training.steps import make_train_step, train_state
from .build import build_model
from .profile_serve import report
from .train import data_config_for

STEPS = 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="cosmoflow",
                    choices=list(ORACLE_BATCH))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    batch_size = ORACLE_BATCH[args.arch]
    ctx = ShardingCtx("cuda")
    cfg = get_config(args.arch)
    model = build_model(cfg, ctx, seed=0)
    batch = Loader(data_config_for(cfg.model, batch_size), ctx.device
                   ).batch_at(0)
    opt = OptimizerConfig(name="sgd")
    step, state = make_train_step(model, opt, ctx), train_state(model, opt)
    for _ in range(2):                                     # warm-up
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    report(f"{args.arch}_b{batch_size}_train_x{STEPS}", prof, host_s, None)


if __name__ == "__main__":
    main()
