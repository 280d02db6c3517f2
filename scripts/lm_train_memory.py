#!/usr/bin/env python3
"""What an LM training step at full width saves for its backward, layer by
layer, reckoned on the ``meta`` device (nothing is allocated or computed).

    PYTHONPATH=src python scripts/lm_train_memory.py \\
        [--arch qwen1.5-4b|mamba2-780m] [--batch 2] [--seq 512]

Builds one layer of the published model on ``meta``, runs its forward (and
the head's) as the trainer does (plain path, query chunk min(256, seq))
under ``torch.autograd.graph.saved_tensors_hooks``, and sums the bytes of
the distinct storages the autograd graph keeps; the weights a layer saves
count with it. Prints the largest saved tensors of one layer and
layers × (one layer) + the head: an estimate of the activation memory at
the end of the forward, beside the parameters' bytes and AdamW's fp32
moments. A CPU reckoning from shapes, not a device measurement; the
lm-train phase of chip_smoke.py prints the card's peak beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.nn.module import ShardingCtx  # noqa: E402

META = torch.device("meta")


def saved_bytes(fn) -> tuple[int, dict]:
    """Bytes of the distinct storages autograd saves while ``fn`` runs,
    and {(shape, dtype): bytes} of each."""
    seen: dict[int, tuple] = {}
    keep = []                       # keeps each storage (and its id) alive

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen[st._cdata] = ((tuple(t.shape), t.dtype), st.nbytes())
            keep.append(st)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(b for _, b in seen.values()), dict(seen.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b",
                    choices=["qwen1.5-4b", "mamba2-780m"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    full = get_config(args.arch).model
    model = TransformerLM(dataclasses.replace(full, n_layers=1), device=META,
                          generator=None)
    ctx = ShardingCtx("cpu")
    tokens = torch.zeros((args.batch, args.seq), dtype=torch.int32,
                         device=META)
    h = model._embed(tokens, ctx).detach().requires_grad_()
    layer, tensors = saved_bytes(
        lambda: model.blocks[0](h, ctx, min(256, args.seq)))
    head, _ = saved_bytes(lambda: model._logits(h, ctx))
    n_params = TransformerLM(full, device=META, generator=None).num_params()
    act = full.n_layers * layer + head
    print(f"{args.arch} batch={args.batch} seq={args.seq}: saved per layer "
          f"{layer / 1e9:.4g} GB (its weights included), head "
          f"{head / 1e9:.4g} GB, x {full.n_layers} layers + head = "
          f"{act / 1e9:.4g} GB; parameters {n_params} "
          f"({n_params * 2 / 1e9:.4g} GB in bf16, gradients the same), "
          f"AdamW moments {n_params * 8 / 1e9:.4g} GB")
    for (shape, dtype), nbytes in sorted(tensors.items(),
                                         key=lambda kv: -kv[1])[:8]:
        print(f"  {nbytes / 1e6:10.1f} MB  {shape} {dtype}")


if __name__ == "__main__":
    main()
