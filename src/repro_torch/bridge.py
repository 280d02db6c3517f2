"""Carry JAX parameters and optimizer state over into the port.

The JAX package's trees are nested dicts/lists; pass them with numpy leaves
(``jax.tree.map(np.asarray, params)``). A leaf at path ``blocks/3/conv2/w``
lands in the port's parameter ``blocks.3.conv2.w``. Both packages keep the
NHWC/HWIO layouts, so every leaf is copied as it is, never transposed. Any
leaf that is missing, extra, or of the wrong shape or dtype raises, so a
parity test cannot run on a partly filled model.
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


@torch.no_grad()
def _copy_into(targets: dict[str, torch.Tensor], tree, what: str) -> None:
    leaves = flatten(tree)
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    wrong = [f"{k}: {tuple(np.shape(leaves[k]))} != {tuple(targets[k].shape)}"
             for k in sorted(set(targets) & set(leaves))
             if tuple(np.shape(leaves[k])) != tuple(targets[k].shape)]
    if missing or extra or wrong:
        raise ValueError(f"{what} tree does not match the port: missing "
                         f"{missing}, extra {extra}, wrong shape {wrong}")
    for k, t in targets.items():
        src = torch.from_numpy(np.array(leaves[k], order="C"))   # a copy
        if src.dtype != t.dtype:
            raise ValueError(f"{what} leaf {k}: dtype {src.dtype} != "
                             f"{t.dtype}")
        t.copy_(src)


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
        _copy_into(moments, tree["opt"][k], f"opt/{k}")
    state["step"] = int(np.asarray(tree["step"]))
