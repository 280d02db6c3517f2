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

    PYTHONPATH=src python scripts/lm_train_memory.py --arch qwen1.5-4b \
        --strategies data,spatial,filter,channel,df,ds,df_zero1,df_zero3

With ``--strategies``: the model and shape of chip_smoke.py's
lm-parallel phase (``configs.lm_archs.LM_PARALLEL_SHAPE``: the published
widths cut to 2 layers, fp32, 4 ranks on a (2, 2) mesh) under each rules
table, one rank's share: the bytes of its parameter blocks, of their
gradients and SGD momentum (ZeRO-1's blocks under df_zero1), and of what
the sharded loss's forward saves for the backward beyond those blocks
(gathered weights and activations), reckoned on ``meta``
with a stand-in mesh (the collectives only give shapes there). The
collectives' buffers are transient and not counted; nor are the
backward's temporaries (the logits' gradient is as large as the logits)
or the update's (one parameter-sized temporary at a time).

    PYTHONPATH=src python scripts/lm_train_memory.py --arch qwen1.5-4b \
        --pipeline --grid

With ``--pipeline``: the model and shape of chip_smoke.py's lm-pipeline
phase (``configs.lm_archs.LM_PIPELINE_SHAPE``, 4 stages, S = 4
microbatches, cut on the oracle's per-layer costs), each stage's share:
every rank holds the whole model and SGD momentum (the train state is
whole on every rank), the gradients of what it owns, and what its layers
save for the backward per microbatch in flight (gpipe: all S; 1F1B: p − r
on stage r), the first stage's embedding and the last stage's head and
logits included. With ``--grid`` (an attention LM): one rank of the
(1, 2, 2) SUMMA grid under the "summa" table at the lm-parallel shape:
parameter blocks of about 1/(r·c), their gradients and momentum, and what
the forward saves beyond them (the gathered activations and the weight
panels each SUMMA product keeps for its backward).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.lm_archs import (LM_PARALLEL_SHAPE,  # noqa: E402
                                          LM_PIPELINE_SHAPE,
                                          lm_parallel_arch)
from repro_torch.core.layer_stats import stats_for  # noqa: E402
from repro_torch.core.partition import min_max_partition  # noqa: E402
from repro_torch.launch.mesh import Group  # noqa: E402
from repro_torch.models.transformer import TransformerLM, _xent  # noqa: E402
from repro_torch.nn.module import ShardingCtx  # noqa: E402
from repro_torch.optim.optimizers import (OptimizerConfig,  # noqa: E402
                                          init_state)
from repro_torch.parallel.sharded import Sharded, placement  # noqa: E402
from repro_torch.parallel.schedules import pipeline_block_costs  # noqa: E402
from repro_torch.parallel.sharded import shard_params  # noqa: E402
from repro_torch.parallel.strategies import make_rules  # noqa: E402

META = torch.device("meta")


def saved_bytes(fn, skip=()) -> tuple[int, dict]:
    """Bytes of the distinct storages autograd saves while ``fn`` runs
    (but those of the tensors ``skip``), and {(shape, dtype): bytes} of
    each."""
    seen: dict[int, tuple] = {}
    keep = []                       # keeps each storage (and its id) alive
    skipped = {t.untyped_storage()._cdata for t in skip}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in seen and st._cdata not in skipped:
            seen[st._cdata] = ((tuple(t.shape), t.dtype), st.nbytes())
            keep.append(st)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(b for _, b in seen.values()), dict(seen.values())


class MetaMesh:
    """Rank 0 of a mesh of ranks that do not exist (("data", "model"), or
    the axes given): what the layers read of a mesh, for a forward on
    ``meta``."""

    def __init__(self, *dims: int, axes=("data", "model")):
        self.shape = dict(zip(axes, dims))
        self.size, self.rank = math.prod(dims), 0
        self.device = self.host_device = torch.device("cpu")

    def coord(self, axis: str) -> int:
        return 0

    def group(self, axes) -> Group:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self.shape[a]
        return Group(None, tuple(range(n)), 0, False)


def rank_bytes(arch: str, strategy: str, mesh: MetaMesh) -> dict:
    """One rank's bytes under ``strategy`` at LM_PARALLEL_SHAPE."""
    _, batch, seq = LM_PARALLEL_SHAPE[arch]
    ctx = ShardingCtx("cpu", mesh=mesh, rules=make_rules(strategy))
    model = shard_params(TransformerLM(lm_parallel_arch(arch).model,
                                       device=META, generator=None), ctx)
    params = dict(model.named_parameters())
    state = init_state(OptimizerConfig(name="sgd", zero1="zero1" in strategy),
                       params, ctx)
    tokens = torch.zeros((batch, seq), dtype=torch.int32, device=META)
    tokens = Sharded.of(tokens, placement(mesh, ctx.pspec(
        ("batch", None), tokens.shape)), mesh)
    saved, _ = saved_bytes(lambda: model.loss_fn(
        {"tokens": tokens}, ctx, q_chunk=min(256, seq)), params.values())
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    return {"weights": nbytes, "grads": nbytes,
            "momentum": sum(t.numel() * 4 for t in state["mom"].values()),
            "saved": saved}


def pipeline_bytes(arch: str, p: int = 4, segments: int = 4) -> list[dict]:
    """Each stage's bytes at LM_PIPELINE_SHAPE (see the module
    docstring)."""
    layers, batch, seq = LM_PIPELINE_SHAPE[arch]
    mc = lm_parallel_arch(arch, layers).model
    model = TransformerLM(mc, device=META, generator=None)
    ctx, mb = ShardingCtx("cpu"), batch // segments
    tokens = torch.zeros((mb, seq), dtype=torch.int32, device=META)
    h = model._embed(tokens, ctx).detach().requires_grad_()
    weights = list(model.parameters())
    per_layer = [saved_bytes(lambda blk=blk: blk(h, ctx, min(256, seq)),
                             weights)[0] for blk in model.blocks]
    head = saved_bytes(lambda: _xent(model._logits(h, ctx), tokens),
                       weights)[0]
    bounds = min_max_partition(pipeline_block_costs(
        model, stats_for(mc, seq)), p).bounds
    nbytes = {k: t.numel() * t.element_size()
              for k, t in model.named_parameters()}
    out = []
    for r in range(p):
        own = tuple(f"blocks.{j}." for j in range(bounds[r], bounds[r + 1]))
        if r == 0:
            own += ("embed.",)
        if r == p - 1:
            own += ("final_norm.", "head") + (
                ("embed.",) if mc.tie_embeddings else ())
        saved = sum(per_layer[bounds[r]:bounds[r + 1]]) + (
            head if r == p - 1 else 0)
        out.append({"layers": bounds[r + 1] - bounds[r],
                    "weights": sum(nbytes.values()),
                    "momentum": sum(nbytes.values()),
                    "grads": sum(b for k, b in nbytes.items()
                                 if k.startswith(own)),
                    "saved_gpipe": segments * saved,
                    "saved_1f1b": min(p - r, segments) * saved})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b",
                    choices=["qwen1.5-4b", "mamba2-780m"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--strategies", default=None,
                    help="comma-separated rules tables: one rank's bytes "
                         "at the lm-parallel shape under each")
    ap.add_argument("--pipeline", action="store_true",
                    help="each stage's bytes at the lm-pipeline shape")
    ap.add_argument("--grid", action="store_true",
                    help="one rank's bytes on the (1, 2, 2) SUMMA grid")
    args = ap.parse_args(argv)
    if args.pipeline:
        layers, batch, seq = LM_PIPELINE_SHAPE[args.arch]
        print(f"{args.arch} {layers} layers fp32 batch={batch} seq={seq}, "
              f"4 stages, S=4, GB:")
        for r, b in enumerate(pipeline_bytes(args.arch)):
            fixed = b["weights"] + b["momentum"] + b["grads"]
            print(f"  stage {r} " + " ".join(
                f"{k}={v / 1e9:.4g}" if k != "layers" else f"{k}={v}"
                for k, v in b.items())
                + f" sum_gpipe={(fixed + b['saved_gpipe']) / 1e9:.4g}"
                f" sum_1f1b={(fixed + b['saved_1f1b']) / 1e9:.4g}")
    if args.grid:
        layers, batch, seq = LM_PARALLEL_SHAPE[args.arch]
        b = rank_bytes(args.arch, "summa",
                       MetaMesh(1, 2, 2, axes=("data", "model_r", "model_c")))
        print(f"{args.arch} {layers} layers fp32 batch={batch} seq={seq}, "
              f"one rank of the (1, 2, 2) grid under summa, GB: "
              + " ".join(f"{k}={v / 1e9:.4g}" for k, v in b.items())
              + f" sum={sum(b.values()) / 1e9:.4g}")
    if args.pipeline or args.grid:
        return
    if args.strategies:
        layers, batch, seq = LM_PARALLEL_SHAPE[args.arch]
        mesh = MetaMesh(2, 2)
        print(f"{args.arch} {layers} layers fp32 batch={batch} seq={seq}, "
              f"one rank of a (2, 2) mesh, GB:")
        for s in args.strategies.split(","):
            b = rank_bytes(args.arch, s, mesh)
            total = sum(b.values())
            print(f"  {s:9s} " + " ".join(
                f"{k}={v / 1e9:.4g}" for k, v in b.items())
                + f" sum={total / 1e9:.4g} (x4 ranks {4 * total / 1e9:.4g})")
        return
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
