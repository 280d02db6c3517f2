"""``launch.build.build_cell`` against the reference's ``build_cell``: for
every ported arch at full width and each shape kind (train_4k, and for the
LMs prefill_32k and decode_32k), with ``mesh=None``, under the arch's own
strategy and under ``"auto"`` (the TPU target's p = 1 plan, as the
reference's), the port's cell has the reference's strategy, kind, ZeRO-1
setting, remat switch (the plan's for an LM train cell, stripped for
serving) and the shapes and dtypes of every argument: the train state's
parameters, optimizer slots and step, the batch, a serving cell's cache,
token and position. The reference stacks an LM's layers; its leaves are
compared layer by layer, as ``bridge`` lays them out. The port builds
these cells on ``meta`` (nothing is allocated). A pipeline serving cell
raises, as the reference's does; a built smoke cell runs on the CPU."""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.bridge import flatten
from repro_torch.configs import get_config
from repro_torch.launch.build import build_cell
from repro_torch.nn.module import zeros_like_spec

# One torch thread a test process. The suite runs 6 xdist workers on 8
# cores, and every worker imports this file when it collects: at torch's
# default of a thread per core the workers stall each other and the JAX
# package's multi-device subprocesses (a spawned rank sets the same,
# launch/spawn.py).
torch.set_num_threads(1)

CNNS = ("resnet50", "resnet152", "vgg16", "cosmoflow")
LMS = ("qwen1.5-4b", "mamba2-780m")


def _unstack(leaves: dict) -> dict:
    """The reference's stacked leaves (``<prefix>stacks.<p>.X`` of (G,
    ...), and ``<prefix>tail.<r>.X``) as per-layer ``<prefix>blocks.<layer>.X``
    leaves, as ``bridge._unstack_layers`` lays out arrays (the prefix: the
    parameters', an optimizer slot's, a cache's); each leaf (shape,
    dtype)."""
    found = {}
    for k in leaves:
        m = re.match(r"^(.*?)(stacks|tail)\.(\d+)\.(.*)$", k)
        if m:
            found[k] = m.groups()
    out = {k: v for k, v in leaves.items() if k not in found}
    for prefix in {g[0] for g in found.values()}:
        stacked = [k for k, g in found.items()
                   if g[0] == prefix and g[1] == "stacks"]
        period = 1 + max(int(found[k][2]) for k in stacked)
        n_groups = leaves[stacked[0]][0][0]
        for k, (_, kind, pos, rest) in found.items():
            if found[k][0] != prefix:
                continue
            shape, dtype = leaves[k]
            if kind == "stacks":
                for g in range(shape[0]):
                    out[f"{prefix}blocks.{g * period + int(pos)}.{rest}"] = \
                        (shape[1:], dtype)
            else:
                out[f"{prefix}blocks.{n_groups * period + int(pos)}.{rest}"] \
                    = (shape, dtype)
    return out


def _ref_leaves(tree) -> dict:
    return _unstack({k: (tuple(v.shape), str(np.dtype(v.dtype)))
                     for k, v in flatten(tree).items()})


def _leaves(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in flatten(tree).items()}


def _fields(plan):
    return None if plan is None else dataclasses.asdict(plan)


def _same_args(cell, ref):
    assert len(cell.args) == len(ref.args)
    for i, (a, b) in enumerate(zip(cell.args, ref.args)):
        got, want = _leaves(a), _ref_leaves(b)
        assert got == want, (i, sorted(set(got) ^ set(want))[:6])
    for t in flatten(cell.args).values():
        assert t.device.type == "meta"


def _same_cell(cfg, jcfg, shape, strategy):
    """The cells agree, or both builds raise the same error (a pipeline
    train cell needs a mesh's "model" axis for its stages)."""
    from repro.launch.build import build_cell as j_build_cell
    try:
        ref = j_build_cell(jcfg, shape, None, strategy)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            build_cell(cfg, shape, None, strategy, device="meta")
        assert str(got.value) == str(e)
        return
    cell = build_cell(cfg, shape, None, strategy, device="meta")
    plan = ref.meta.get("plan")
    assert (cell.strategy, cell.kind) == (ref.strategy, ref.kind)
    assert cell.meta["opt"].zero1 == ref.meta["opt"].zero1
    assert _fields(cell.meta.get("plan")) == _fields(plan)
    remat = bool(plan is not None and plan.remat and cfg.family == "lm"
                 and ref.kind == "train")
    assert cell.meta["remat"] == remat
    _same_args(cell, ref)


@pytest.mark.parametrize("arch", CNNS)
def test_cnn_train_cells_equal_the_reference(arch):
    from repro.configs import get_config as j_get_config
    for strategy in (None, "auto"):
        _same_cell(get_config(arch), j_get_config(arch), "train_4k", strategy)


@pytest.mark.parametrize("arch", LMS)
def test_lm_cells_equal_the_reference(arch):
    from repro.configs import get_config as j_get_config
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for strategy in (None, "auto"):
            _same_cell(get_config(arch), j_get_config(arch), shape, strategy)


def test_plan_remat_is_deployed_for_training_and_stripped_for_serving():
    """A plan with remat on (the smoke Qwen under a 200 kB cap, as the
    reference's tuner decides) turns it on in a train cell and off in a
    decode cell, in both packages."""
    from repro.configs import get_config as j_get_config
    from repro.core.autotune import plan_for_arch as j_plan_for_arch
    from repro.core.cluster import ClusterSpec as JClusterSpec
    from repro.launch.build import build_cell as j_build_cell
    from repro_torch.core.autotune import plan_for_arch
    from repro_torch.core.cluster import ClusterSpec
    jcluster = dataclasses.replace(JClusterSpec.of("paper"),
                                   mem_capacity=2e5)
    cluster = dataclasses.replace(ClusterSpec.of("paper"), mem_capacity=2e5)
    cfg, jcfg = get_config("qwen1.5-4b"), j_get_config("qwen1.5-4b")
    plan = plan_for_arch(cfg, "train_4k", 1, cluster=cluster, smoke=True)
    jplan = j_plan_for_arch(jcfg, "train_4k", 1, cluster=jcluster,
                            smoke=True)
    assert _fields(plan) == _fields(jplan) and plan.remat
    for shape, remat in (("train_4k", True), ("decode_32k", False)):
        cell = build_cell(cfg, shape, None, "auto", smoke=True, plan=plan,
                          device="meta")
        ref = j_build_cell(jcfg, shape, None, "auto", smoke=True, plan=jplan)
        assert cell.meta["remat"] is remat
        assert cell.strategy == ref.strategy
        _same_args(cell, ref)


def test_a_pipeline_serving_cell_raises_as_the_reference():
    from repro.configs import get_config as j_get_config
    from repro.launch.build import build_cell as j_build_cell
    for shape in ("prefill_32k", "decode_32k"):
        with pytest.raises(NotImplementedError) as want:
            j_build_cell(j_get_config("qwen1.5-4b"), shape, None, "pipeline")
        with pytest.raises(NotImplementedError) as got:
            build_cell(get_config("qwen1.5-4b"), shape, None, "pipeline",
                       device="meta")
        assert str(got.value) == str(want.value)


def test_built_smoke_serving_cells_run_on_the_cpu():
    """The smoke Qwen's prefill cell, then its decode cell, on caches made
    from their cells' stand-ins (cut to 64 positions), on the CPU: the
    decode step's logits are the prefill pass's next-token logits
    continued."""
    cfg = get_config("qwen1.5-4b")
    pre = build_cell(cfg, "prefill_32k", None, smoke=True, device="cpu")
    dec = build_cell(cfg, "decode_32k", None, smoke=True, device="cpu")
    assert (pre.kind, dec.kind) == ("prefill", "decode")
    dec.model.load_state_dict(pre.model.state_dict())
    assert tuple(pre.args[1]["tokens"].shape) == (32, 32768)
    assert tuple(dec.args[1].shape) == (128, 1)
    cache = zeros_like_spec(pre.model.cache_spec(2, 64), "cpu")
    tokens = torch.randint(0, cfg.smoke_model.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    first, cache = pre.step_fn({"tokens": tokens}, cache)
    nxt = first[:, -1].argmax(-1)[:, None]
    second, _ = dec.step_fn(nxt, cache, 16)
    assert first.shape == (2, 1, cfg.smoke_model.vocab)
    assert second.shape == (2, 1, cfg.smoke_model.vocab)
    assert torch.isfinite(second).all()
