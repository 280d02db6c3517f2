"""The deployable pipeline train step for the paper's CNNs (counterpart of
``repro.parallel.schedules.train_step``, its hetero path).

``make_pipeline_train_step`` keeps the ``make_train_step`` contract,
(state, batch) → (state, metrics), with ``train_state(model, opt)`` and the
whole batch on every rank. The stages are the ranks of the mesh's
"model" axis; the cuts come from the min-max partition
(``core.partition.min_max_partition``) into p·v chunks of the per-block
costs over the oracle's layer table (``pipeline_block_costs`` over
``stats_for(model.cfg)``); any of the three executors of ``runtime.py``
runs them.

The loss lives on the last stage and is the loss of the whole batch: the
mean cross-entropy (CosmoFlow: the MSE) over all B rows, which is the mean
of the S microbatches' means, so microbatch m seeds its backward with its
own mean ÷ S. (The 1/p seed ``make_train_step`` gives a loss that all p
ranks hold does not apply: one rank holds each microbatch's loss.)
BatchNorm takes per-microbatch statistics (each chunk runs on a
microbatch, mesh-free), as in the reference, so ResNet and VGG match the
serial step at the microbatch size (``make_train_step(accum=S)``, whose
microbatch m is rows [m·B/S, (m+1)·B/S), as here) and CosmoFlow, which has
no BatchNorm, the plain step.

Parameter layout. Every rank holds the whole model (built from the same
seed) but updates only the blocks it owns, with ``optim.apply_update``;
the clipping norm is the whole model's, √ of the sum of the stages' squared
norms: one all-reduce of two scalars over the stage group, which also
hands the loss from the last stage to every rank. A non-owner's copy of a
block is left as it was; ``gather_pipeline_state`` broadcasts each block
(and its optimizer slots) from its owner where the whole state is needed.
The reference instead keeps the parameters replicated and psums the whole
gradient tree; on one card shared by 4 gloo ranks that would put ResNet-50's
102 MB host-staged all-reduce into every step (about 0.75 s, going by the
data-parallel profile), which the paper's layer strategy does not have and
the oracle does not price. The updated parameters are the same either way.

The stacked-LM layouts (``stages.py``) and the mixed-LM path of the
reference are not ported yet (ROADMAP queue 1 item 8): an LM raises.
"""
from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ...core.layer_stats import stats_for
from ...core.partition import min_max_partition
from ...models.cnn import CosmoFlowConfig, ResNetConfig, VGGConfig
from ...models.transformer import LMConfig
from ...optim.optimizers import OptimizerConfig, apply_update
from .. import collectives as C
from .hetero import LM_PIPELINE, boundaries, meta_twin, model_pipe_blocks
from .runtime import SCHEDULE_NAMES, SCHEDULES, StageProgram


def pipeline_supported(model_or_cfg) -> str | None:
    """None when a pipeline schedule can deploy this model, else the
    reason."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    if isinstance(cfg, (ResNetConfig, VGGConfig, CosmoFlowConfig)):
        return None
    if isinstance(cfg, LMConfig):
        return LM_PIPELINE
    return (f"{type(cfg).__name__}: no pipeline block decomposition (the "
            f"paper's CNNs pipeline)")


def clip_segments(batch: int, segments: int) -> int:
    """Largest microbatch-segment count ≤ ``segments`` dividing ``batch``."""
    s = max(min(int(segments), int(batch)), 1)
    while batch % s:
        s -= 1
    return s


def resolve_segments(batch: int, segments: int,
                     multiple_of: int = 1) -> int:
    """``clip_segments`` that surfaces silent degradation.

    Returns the largest S ≤ ``segments`` that divides ``batch`` (and is a
    multiple of ``multiple_of``: the interleaved schedule's S % p == 0),
    warning when the pipe runs with fewer microbatches than requested: a
    prime batch clips all the way to S = 1, which serializes the pipeline
    (bubble (p−1)/S)."""
    batch, m = int(batch), max(int(multiple_of), 1)
    s = max(min(int(segments), batch), 1)
    while s > 0 and (batch % s or s % m):
        s -= 1
    if s < 1:
        raise ValueError(
            f"no segment count ≤ {segments} divides batch {batch} and is a "
            f"multiple of {m} (the interleaved schedule needs S % p == 0)")
    if s < int(segments):
        warnings.warn(
            f"pipeline segments clipped: requested {segments}, running "
            f"S={s} (batch {batch}"
            + (f", S must be a multiple of p={m}" if m > 1 else "")
            + (") — the pipe is fully serialized" if s == 1 else ")"),
            stacklevel=2)
    return s


def make_pipeline_train_step(model, opt: OptimizerConfig, ctx,
                             segments: int = 8, schedule: str = "gpipe",
                             virtual_stages: int = 2) -> Callable:
    """Pipeline train step: (state, batch) → (state, metrics).

    Stages = the ranks of ``ctx.mesh``'s "model" axis (ranks on its other
    axes run the same pipe on the same batch, as the reference's
    replicated microbatches), cut on the blocks' fw+bw costs over the
    oracle's layer table. ``segments`` is the requested microbatch count;
    the step resolves the largest deployable S ≤ it (``resolve_segments``)
    and reports it as ``metrics["pipeline_segments"]``. ``schedule``: one of
    ``SCHEDULE_NAMES``; ``virtual_stages``: the interleaved v.

    The returned step carries ``bounds`` (the chunk cuts over the blocks),
    ``group`` (the stage group) and ``owner`` (parameter name → the stage
    index that updates it), which ``gather_pipeline_state`` reads."""
    if schedule not in SCHEDULE_NAMES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"pick one of {SCHEDULE_NAMES}")
    reason = pipeline_supported(model)
    if reason is not None:
        raise NotImplementedError(f"pipeline cannot deploy: {reason}")
    mesh = ctx.mesh
    if mesh is None or "model" not in mesh.shape:
        raise ValueError("pipeline needs a mesh with a 'model' axis")
    group = mesh.group("model")
    p = group.size
    v = int(virtual_stages) if schedule == "interleaved" else 1
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    n_chunks = p * v
    blocks = model_pipe_blocks(model, stats_for(model.cfg))
    L = len(blocks)
    if n_chunks > L:
        raise ValueError(f"{p} stages × {v} virtual exceed {L} blocks")
    bounds = min_max_partition(np.asarray([b.cost for b in blocks]),
                               n_chunks).bounds
    owner = {k: j % p for j in range(n_chunks)
             for b in blocks[bounds[j]:bounds[j + 1]] for k in b.params}
    owned = [k for k, r in owner.items() if r == group.index]
    shape_blocks = model_pipe_blocks(meta_twin(model))
    seg_multiple = p if schedule == "interleaved" else 1
    kw = {"virtual_stages": v} if schedule == "interleaved" else {}

    def run(j, x):
        for blk in blocks[bounds[j]:bounds[j + 1]]:
            x = blk.apply(x)
        return x

    def train_step(state, batch):
        images = batch["images"]
        B = images.shape[0]
        S = resolve_segments(B, segments, seg_multiple)
        mb = B // S
        bnd = boundaries(shape_blocks, torch.empty(
            (mb,) + tuple(images.shape[1:]), dtype=images.dtype,
            device="meta"))
        # the loss's own metric name ("ce", "mse"), from a shapes-only call
        metric, = model.loss(
            torch.empty((mb,) + bnd[-1][0], dtype=bnd[-1][1], device="meta"),
            {k: t[:mb].to("meta") for k, t in batch.items()})[1]

        def rows(m):
            return {k: t[m * mb:(m + 1) * mb] for k, t in batch.items()}

        def loss_share(m, out):
            return model.loss(out, rows(m))[0] / S

        params = state["params"]
        for k in owned:
            params[k].grad = None
        program = StageProgram(
            group, n_chunks, run, lambda m: rows(m)["images"], loss_share,
            lambda j: ((mb,) + bnd[bounds[j]][0], bnd[bounds[j]][1]),
            ctx.device)
        shares = SCHEDULES[schedule](program, S, **kw)
        grads = {k: params[k].grad if params[k].grad is not None
                 else torch.zeros_like(params[k]) for k in owned}
        sq = sum((g.float().square().sum() for g in grads.values()),
                 torch.zeros((), device=ctx.device))
        loss = sum(shares, torch.zeros((), device=ctx.device))
        total = C.all_reduce_sum(torch.stack([sq, loss.float()]), group)
        om = apply_update(opt, {k: params[k] for k in owned}, grads,
                          state["opt"], state["step"], total[0].sqrt())
        for k in owned:
            params[k].grad = None
        state["step"] += 1
        return state, dict({metric: total[1]}, loss=total[1],
                           pipeline_segments=S, **om)

    train_step.bounds, train_step.group = bounds, group
    train_step.owner = owner
    return train_step


@torch.no_grad()
def gather_pipeline_state(state: dict, step) -> dict:
    """The whole train state on every stage rank: each stage broadcasts
    the parameters it owns and their optimizer slots (one flat buffer per
    dtype) over the stage group. Updates ``state`` in place."""
    group = step.group
    for r in range(group.size):
        keys = [k for k, o in step.owner.items() if o == r]
        ts = [state["params"][k] for k in keys]
        ts += [slot[k] for slot in state["opt"].values() for k in keys]
        for dtype in sorted({t.dtype for t in ts}, key=str):
            part = [t for t in ts if t.dtype == dtype]
            flat = torch.cat([t.detach().reshape(-1) for t in part])
            dist.broadcast(flat, group.ranks[r], group=group.pg)
            for t, piece in zip(part, flat.split([t.numel() for t in part])):
                t.copy_(piece.view_as(t))
    return state
