"""Carry JAX parameters and optimizer state over into the port.

The JAX package's trees are nested dicts/lists; pass them with numpy leaves
(``jax.tree.map(np.asarray, params)``). A leaf at path ``blocks/3/conv2/w``
lands in the port's parameter ``blocks.3.conv2.w``. The JAX LMs stack their
layers as ``TransformerLM._groups`` lays them out: leaf ``stacks/p/X``
holds, at index g, layer g·period + p (period = the number of pattern
positions), and a pattern that does not divide the layers leaves a
remainder, ``tail/r/X``, layer n_groups·period + r (n_groups = n_layers //
period, every stack's length); each lands in the port's per-layer
``blocks.<layer>.X``. The reference's ``lead`` (``first_k_dense`` leading
dense layers, unstacked) has no counterpart: the port's ``LMConfig`` has no
such field, which comes with DeepSeek-V3 (ROADMAP queue 1 item 10), so a
``lead`` leaf is an extra leaf and raises. Both packages keep the same layouts, so every leaf is
copied as it is, never transposed; bf16 leaves (numpy arrays of
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects) go through their
16-bit pattern. Any leaf that is missing, extra, or of the wrong shape or
dtype raises, so a parity test cannot run on a partly filled model. A model
on the ``meta`` device is checked, not filled. A model whose parameters are
one rank's blocks (``parallel.sharded.shard_params``) is checked against the
whole leaves and takes each leaf's block (``p.shard_index``); so are the
optimizer moments of its train state (ZeRO-1's moments their own blocks).

``cache_from_jax`` turns the reference's LM cache or paged pool (its
layers stacked, ``stacks/p/k`` of (G, ...)) into the port's per-layer list
``{"blocks": [{"k", "v"}, ...]}``, so caches and pools compare leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """{dotted path: leaf} of a nested dict/list tree (None subtrees skipped)."""
    if isinstance(tree, Mapping):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def _unstack_layers(leaves: dict[str, Any]) -> dict[str, Any]:
    stacked = [k for k in leaves if k.startswith("stacks.")]
    if not stacked:
        return leaves
    period = 1 + max(int(k.split(".")[1]) for k in stacked)
    n_groups = np.shape(leaves[stacked[0]])[0]
    out = {k: v for k, v in leaves.items()
           if not k.startswith(("stacks.", "tail."))}
    for k in stacked:
        _, pos, rest = k.split(".", 2)
        for g in range(np.shape(leaves[k])[0]):
            out[f"blocks.{g * period + int(pos)}.{rest}"] = leaves[k][g]
    for k in leaves:
        if k.startswith("tail."):
            _, r, rest = k.split(".", 2)
            out[f"blocks.{n_groups * period + int(r)}.{rest}"] = leaves[k]
    return out


def _torch_dtype(leaf) -> torch.dtype:
    dt = np.dtype(leaf.dtype if hasattr(leaf, "dtype") else
                  np.asarray(leaf).dtype)
    if dt.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dt)).dtype


def _to_tensor(leaf) -> torch.Tensor:
    a = np.array(leaf, order="C")                    # a copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _whole_shape(t: torch.Tensor) -> tuple:
    return tuple(getattr(t, "global_shape", t.shape))


def _index(t: torch.Tensor, block: torch.Tensor):
    """The slices of the whole leaf that ``t`` holds: its own
    ``shard_index``, else that of the parameter it shares a placement
    with."""
    return getattr(t, "shard_index", getattr(block, "shard_index", ...))


@torch.no_grad()
def _copy_into(targets: dict[str, torch.Tensor], tree, what: str,
               blocks: dict[str, torch.Tensor] | None = None) -> None:
    """``blocks``: the parameters whose placement the targets share (the
    targets themselves unless given)."""
    blocks = targets if blocks is None else blocks
    leaves = _unstack_layers(flatten(tree))
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    wrong = [f"{k}: {tuple(np.shape(leaves[k]))} != "
             f"{_whole_shape(blocks[k])}"
             for k in sorted(set(targets) & set(leaves))
             if tuple(np.shape(leaves[k])) != _whole_shape(blocks[k])]
    if missing or extra or wrong:
        raise ValueError(f"{what} tree does not match the port: missing "
                         f"{missing}, extra {extra}, wrong shape {wrong}")
    for k, t in targets.items():
        dtype = _torch_dtype(leaves[k])
        if dtype != t.dtype:
            raise ValueError(f"{what} leaf {k}: dtype {dtype} != {t.dtype}")
        if t.device.type != "meta":
            whole = _to_tensor(leaves[k])
            t.copy_(whole[_index(t, blocks[k])])


def load_jax_params(model: torch.nn.Module, tree) -> None:
    """Fill ``model``'s parameters from a JAX parameter tree."""
    _copy_into(dict(model.named_parameters()), tree, "params")


def load_jax_state(state: dict, tree) -> None:
    """Fill a port train state (``training.steps.train_state``) from a JAX
    train state ``{"params", "opt", "step"}``: parameters, optimizer
    moments and the step count."""
    _copy_into(state["params"], tree["params"], "params")
    if set(state["opt"]) != set(tree["opt"]):
        raise ValueError(f"optimizer state keys {sorted(tree['opt'])} != "
                         f"{sorted(state['opt'])}")
    for k, moments in state["opt"].items():
        _copy_into(moments, tree["opt"][k], f"opt/{k}", state["params"])
    state["step"] = int(np.asarray(tree["step"]))


def cache_from_jax(tree) -> dict:
    """The port's ``{"blocks": [{name: tensor}, ...]}`` cache (or pool) of a
    JAX LM cache or pool tree with numpy leaves, layers unstacked."""
    leaves = _unstack_layers(flatten(tree))
    other = sorted(k for k in leaves if not k.startswith("blocks."))
    if other:
        raise ValueError(f"cache leaves outside the layer stacks: {other}")
    n = 1 + max(int(k.split(".")[1]) for k in leaves)
    blocks: list[dict] = [{} for _ in range(n)]
    for k, v in leaves.items():
        _, layer, name = k.split(".", 2)
        blocks[int(layer)][name] = _to_tensor(v)
    return {"blocks": blocks}
