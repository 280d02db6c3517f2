"""How far two computations of the same SSM prompt pass drift apart, layer
by layer, on one GPU: the floor under any kernel-vs-plain logit bar.

    PYTHONPATH=src python -m repro_torch.launch.serve_drift \\
        [--dtype bfloat16|float32]

Builds Mamba-2 780m at full width (random weights from seed 0; ``--dtype``
float32 casts every weight to fp32) and runs one prompt pass (4 prompts of
2048 tokens, from a zeroed cache) three ways: the kernel path
(``use_pallas``), the plain path, and the plain path with the SSD's chunk
halved, which computes the same function with its sums in another order.
Prints, for kernel vs plain and for plain vs plain at half the chunk, the
logit distance and the hidden-state distance after every 4th layer, each
as max |a - b| / max |b|. The second pair is what any change of rounding
order costs; a kernel-vs-plain bar cannot sit below it. Imports nothing of
jax or of the JAX package; needs CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_config
from ..nn.module import ShardingCtx, zeros_like_spec
from .build import build_model

ARCH, B, S = "mamba2-780m", 4, 2048


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


@torch.no_grad()
def prompt_pass(model, ctx: ShardingCtx, tokens, chunk: int):
    """(hidden states after each block, last-position logits), with every
    SSD block cut into chunks of ``chunk``."""
    for blk in model.blocks:
        blk.mixer.cfg = dataclasses.replace(blk.mixer.cfg, chunk=chunk)
    cache = zeros_like_spec(model.cache_spec(B, S), tokens.device)
    hs, h = [], model._embed(tokens, ctx)
    for blk, c in zip(model.blocks, cache["blocks"], strict=True):
        h, _ = blk.prefill(h, c, ctx)
        hs.append(h.float())
    return hs, model._logits(h[:, -1:].contiguous(), ctx)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_drift: CUDA is not available")
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    dtype = getattr(torch, args.dtype)
    mc = cfg.model
    mc = dataclasses.replace(mc, dtype=dtype, ssm=dataclasses.replace(
        mc.ssm, dtype=dtype))
    model = build_model(dataclasses.replace(cfg, model=mc), ShardingCtx(dev),
                        seed=0)
    tokens = torch.randint(0, mc.vocab, (B, S), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    chunk = mc.ssm.chunk
    kernel = prompt_pass(model, ShardingCtx(dev, use_pallas=True), tokens,
                         chunk)
    plain = prompt_pass(model, ShardingCtx(dev), tokens, chunk)
    half = prompt_pass(model, ShardingCtx(dev), tokens, chunk // 2)
    for name, (ha, la), (hb, lb) in (
            (f"kernel vs plain, chunk {chunk}", kernel, plain),
            (f"plain chunk {chunk // 2} vs plain chunk {chunk}", half, plain)):
        layers = " ".join(f"{i}:{_rel(a, b):.3e}" for i, (a, b) in
                          enumerate(zip(ha, hb))
                          if i % 4 == 0 or i == len(ha) - 1)
        print(f"[drift] {ARCH} {args.dtype} {name}: logits "
              f"{_rel(la, lb):.4g}; hidden by layer {layers}", flush=True)


if __name__ == "__main__":
    main()
