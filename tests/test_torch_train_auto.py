"""``launch/train.py --strategy auto`` on the CPU: the trainer tunes with the
port's ``core.autotune``, prints the plan and deploys it (its rules table
on the mesh ``runtime.elastic.bind_plan`` shapes, ZeRO-1 and remat from
its switches, a pipeline plan's schedule), at the smoke widths.

In one process (p = 1) and on 4 gloo ranks (one spawn for the file), the
plan is the reference's ``autotune`` for the same arguments (the
reference's trainer's call, on the reference's smoke config), field for
field, and the losses of 2 steps equal those of the same executable
strategy deployed by hand (``--strategy <table>``; the plan's ZeRO-1 and
remat change no number: the update is elementwise, the recomputed forward
the same operations), within 1e-6 relative. The cases on 4 ranks: the
smoke ResNet-50 on the ``host`` system (data, ZeRO-1); the smoke
Qwen1.5-4B on the ``paper`` system with a 0.5 MB memory cap read from a
``--cluster`` JSON (df_zero3 on a (2, 2) mesh with remat on, every block
checkpointed; in one process a 0.2 MB cap, where nothing fits and the
tuner falls back to df with remat); the smoke Mamba-2 780m on ``paper`` (gpipe over 4 stages).
A summa plan, forced, deploys the (1, 2, 2) grid (``summa_matmul`` runs)
and gives the single-process trainer's first loss within 1e-5, the bar
of tests/test_torch_lm_parallel.py's trainer check. A plan the port cannot
run (summa on a CNN or an SSM LM, ep) raises and names its ROADMAP item.

Rank functions live at module level and jax is imported only inside
functions: the spawned ranks import this module.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core.autotune import TunedPlan
from repro_torch.core.cluster import ClusterSpec
from repro_torch.launch import train
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import transformer
from repro_torch.parallel.summa import summa_matmul

B, SEQ, STEPS = 8, 32, 2
CNN_B = 2           # the smoke ResNet-50's one-process batch (224² images)
LOSS_RTOL = 1e-6
SUMMA_RTOL = 1e-5
# memory caps (bytes) under which the tuner turns remat on for the smoke
# Qwen: nothing fits at p = 1 (the fallback, df with remat), df_zero3 with
# remat fits on (2, 2) at p = 4
SOLO_CAP, RANKS_CAP = 2e5, 5e5


def _argv(arch, *extra, batch=B):
    return ["--arch", arch, "--smoke", "--steps", str(STEPS), "--batch",
            str(batch), "--seq", str(SEQ), "--device", "cpu", *extra]


def _reference_plan(arch, p, cluster_args, batch=B):
    """The reference trainer's ``--strategy auto`` call, on the reference's
    smoke config."""
    import importlib

    from repro.configs import get_config as j_get_config
    from repro.core.cluster import ClusterSpec as JClusterSpec
    from repro.core.oracle import TimeModel as JTimeModel
    from repro.parallel.pipeline import (pipeline_block_count,
                                         pipeline_supported)
    ja = importlib.import_module("repro.core.autotune")
    cfg = j_get_config(arch)
    mc = cfg.smoke_model
    system, path = cluster_args
    cluster = (JClusterSpec.from_json(path) if path
               else JClusterSpec.of(system))
    return ja.autotune(ja.stats_for_model(mc, SEQ),
                       JTimeModel(cluster.system),
                       cluster.oracle_config(B=batch, D=batch,
                                             virtual_stages=2), p,
                       schedules="all", fallback=cfg.strategy,
                       cluster=cluster, allow_remat=cfg.family != "cnn",
                       allow_pipeline=pipeline_supported(mc) is None,
                       max_stages=pipeline_block_count(mc))


def _same_plan(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for k, v in w.items():
        if isinstance(v, float):
            np.testing.assert_allclose(g[k], v, rtol=1e-12, err_msg=k)
        else:
            assert g[k] == v, (k, g[k], v)
    assert got.describe() == want.describe()


def _cluster_flags(cluster_args):
    system, path = cluster_args
    return ["--cluster", path] if path else ["--system", system]


def _tight_cluster(path, cap: float) -> str:
    d = ClusterSpec.of("paper").to_json()
    d["mem_capacity"] = cap
    with open(path, "w") as f:
        json.dump(d, f)
    return str(path)


def _counting_checkpoint(calls: list):
    real = torch.utils.checkpoint.checkpoint

    def counted(fn, *args, **kw):
        calls.append(1)
        return real(fn, *args, **kw)
    return counted


# --------------------------------------------------------------------------
# one process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["resnet50", "qwen1.5-4b", "mamba2-780m"])
def test_single_process_plan_is_the_references(arch, capsys):
    """p = 1 on the host system: the printed plan is the reference's, and
    the single-device trainer trains as without ``auto``. The smoke CNN
    (224² images) runs at batch 2, its plan tuned at that batch."""
    batch = CNN_B if arch == "resnet50" else B
    out = train.main(_argv(arch, "--strategy", "auto", batch=batch))
    want = _reference_plan(arch, 1, ("host", None), batch=batch)
    assert capsys.readouterr().out.splitlines()[0] == want.describe()
    _same_plan(out["plan"], want)
    assert out["strategy"] == want.exec_strategy("train")
    assert out["mesh"] is None and len(out["losses"]) == STEPS
    hand = train.main(_argv(arch, batch=batch))["losses"]
    np.testing.assert_allclose(out["losses"], hand, rtol=LOSS_RTOL)


def test_single_process_deploys_the_plans_remat(tmp_path, monkeypatch):
    """A memory cap no point fits: the tuner falls back to the arch's
    strategy with remat on, and the trainer runs every block under the
    checkpoint, with the losses of the run without it."""
    path = _tight_cluster(tmp_path / "tight.json", SOLO_CAP)
    calls = []
    monkeypatch.setattr(transformer, "checkpoint", _counting_checkpoint(calls))
    out = train.main(_argv("qwen1.5-4b", "--strategy", "auto", "--cluster",
                           path))
    plan = out["plan"]
    _same_plan(plan, _reference_plan("qwen1.5-4b", 1, ("paper", path)))
    assert plan.remat and not plan.feasible
    assert len(calls) == 2 * STEPS                 # 2 layers, each step
    calls.clear()
    hand = train.main(_argv("qwen1.5-4b"))["losses"]
    assert calls == []
    np.testing.assert_allclose(out["losses"], hand, rtol=LOSS_RTOL)


def _plan(strategy, p=1, p1=1, p2=1, **kw):
    base = dict(strategy=strategy, p=p, p1=p1, p2=p2, remat=False,
                zero1=False, zero3=False, seq_parallel=False,
                bottleneck="comp-bound", total_s=1.0, iterations=1.0,
                mem_bytes=1.0, mem_cap=None, feasible=True, source="sweep")
    return TunedPlan(**dict(base, **kw))


def test_undeployable_plans_raise_and_name_their_item(monkeypatch):
    """summa on a CNN or an SSM LM: item 8; ep: item 10. Nothing falls
    back to another strategy."""
    for arch, plan, item in (
            ("resnet50", _plan("summa", p2r=1, p2c=1), "item 8"),
            ("mamba2-780m", _plan("summa"), "item 8"),
            ("qwen1.5-4b", _plan("ep"), "item 10")):
        monkeypatch.setattr(train, "autotune", lambda *a, plan=plan, **k:
                            plan)
        with pytest.raises(NotImplementedError, match=item):
            train.main(_argv(arch, "--strategy", "auto"))


# --------------------------------------------------------------------------
# 4 ranks, one spawn
# --------------------------------------------------------------------------

def _cases(tight: str):
    """(name, arch, (system, cluster JSON), hand-deployed flags)."""
    return (("resnet50-host", "resnet50", ("host", None),
             ["--strategy", "data", "--model-axis", "1"]),
            ("qwen-tight", "qwen1.5-4b", ("paper", tight),
             ["--strategy", "df_zero3", "--model-axis", "2"]),
            ("mamba-paper", "mamba2-780m", ("paper", None),
             ["--strategy", "pipeline"]))


SUMMA_PLAN = _plan("summa", p=4, p1=1, p2=4, p2r=2, p2c=2)


def _ranks(mesh, tight):
    out = {}
    real_ckpt = transformer.checkpoint
    try:
        for name, arch, cl, hand in _cases(tight):
            calls = []
            transformer.checkpoint = _counting_checkpoint(calls)
            auto = train.main(_argv(arch, "--strategy", "auto",
                                    *_cluster_flags(cl)))
            out[name] = dict(auto=auto, calls=len(calls),
                             hand=train.main(_argv(arch, *hand)))
    finally:
        transformer.checkpoint = real_ckpt
    real_tune = train.autotune
    train.autotune = lambda *a, **k: SUMMA_PLAN
    try:
        summa_matmul.calls = 0
        out["summa"] = dict(auto=train.main(_argv("qwen1.5-4b", "--strategy",
                                                  "auto")),
                            calls=summa_matmul.calls)
    finally:
        train.autotune = real_tune
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tight = _tight_cluster(tmp_path_factory.mktemp("auto") / "tight.json",
                           RANKS_CAP)
    res = run_ranks(_ranks, 4, tight, backend="gloo", device="cpu",
                    timeout_s=240)
    single = train.main(_argv("qwen1.5-4b"))["losses"]
    return tight, res, single


@pytest.mark.parametrize("case", [c[0] for c in _cases("")])
def test_plans_across_ranks_are_the_references(runs, case):
    tight, res, _ = runs
    _, arch, cl, _ = next(c for c in _cases(tight) if c[0] == case)
    want = _reference_plan(arch, 4, cl)
    for rank, r in enumerate(res):
        _same_plan(r[case]["auto"]["plan"], want)
        assert r[case]["auto"]["strategy"] == want.exec_strategy("train")
        assert r[case]["auto"]["mesh"] == {"data": want.p1,
                                           "model": want.p2}, rank
    expect = {"resnet50-host": ("data", False, True),
              "qwen-tight": ("df_zero3", True, True),
              "mamba-paper": ("pipeline", False, False)}[case]
    assert (want.exec_strategy("train"), want.remat, want.zero1) == expect


@pytest.mark.parametrize("case", [c[0] for c in _cases("")])
def test_losses_equal_the_hand_deployed_strategy(runs, case):
    """The plan's table deployed by hand gives the same losses; the
    plan's remat ran every block under the checkpoint, on every rank."""
    _, res, _ = runs
    for rank, r in enumerate(res):
        auto, hand = r[case]["auto"], r[case]["hand"]
        assert auto["mesh"] == hand["mesh"] and \
            auto["strategy"] == hand["strategy"], rank
        assert all(np.isfinite(auto["losses"])) and \
            len(auto["losses"]) == STEPS
        np.testing.assert_allclose(auto["losses"], hand["losses"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {rank}")
        n_layers = 2 if case == "qwen-tight" else 0
        assert r[case]["calls"] == n_layers * STEPS, (rank, r[case]["calls"])


def test_a_summa_plan_deploys_the_grid(runs):
    _, res, single = runs
    for rank, r in enumerate(res):
        auto = r["summa"]["auto"]
        assert auto["strategy"] == "summa"
        assert auto["mesh"] == {"data": 1, "model_r": 2, "model_c": 2}
        assert r["summa"]["calls"] > 0, rank
        assert abs(auto["losses"][0] - single[0]) <= \
            SUMMA_RTOL * abs(single[0]), (rank, auto["losses"], single)
