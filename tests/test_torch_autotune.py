"""The port's auto-tuner (``repro_torch.core.autotune``) against the
reference's (``repro.core.autotune``), numpy only: no model runs.

For every ported arch, at p in {1, 4, 8, 64}, on the "paper" and "host"
systems, ``plan_for_arch`` returns the reference's ``TunedPlan`` field for
field (the projected seconds and bytes within 1e-12 relative: both
packages evaluate the same numpy expressions over the same layer stats),
for the training shape and, for the LMs, the decode shape (where Qwen's
``shape_strategy`` names serve_seqkv as the fallback). ``autotune`` with
the constraints a deployment passes (a memory cap, a fixed model width, a
grid, a pinned schedule) agrees the same way, and so do the deployability
masks, elementwise. The CLI prints the reference's table, and its
``--smoke`` self-check exits 0.
"""
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core.cluster import ClusterSpec as JClusterSpec
from repro.core.oracle import TimeModel as JTimeModel
from repro_torch.configs import get_config
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.oracle import TimeModel

JA = importlib.import_module("repro.core.autotune")
TA = importlib.import_module("repro_torch.core.autotune")
J_SWEEP = importlib.import_module("repro.core.sweep")
T_SWEEP = importlib.import_module("repro_torch.core.sweep")

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("resnet50", "vgg16", "cosmoflow", "qwen1.5-4b", "mamba2-780m")
PS = (1, 4, 8, 64)
SYSTEMS = ("paper", "host")
RTOL = 1e-12
FLOATS = ("total_s", "mem_bytes", "iterations", "mem_cap")


def _same_plan(got, want, where):
    assert type(got).__name__ == type(want).__name__ == "TunedPlan"
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys(), where
    for k, v in w.items():
        if k in FLOATS and v is not None:
            np.testing.assert_allclose(g[k], v, rtol=RTOL,
                                       err_msg=f"{where} {k}")
        else:
            assert g[k] == v, (where, k, g[k], v)
    assert got.kernel_tiles is None
    assert got.describe() == want.describe(), where
    assert got.exec_strategy("train") == want.exec_strategy("train")
    assert got.exec_strategy("decode") == want.exec_strategy("decode")
    assert got.mesh_spec() == want.mesh_spec()


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_for_arch_matches_the_reference(arch):
    shapes = ("train_4k",) if arch in ("resnet50", "vgg16", "cosmoflow") \
        else ("train_4k", "decode_32k")
    for system in SYSTEMS:
        for shape in shapes:
            for p in PS:
                want = JA.plan_for_arch(j_get_config(arch), shape, p,
                                        cluster=JClusterSpec.of(system))
                got = TA.plan_for_arch(get_config(arch), shape, p,
                                       cluster=ClusterSpec.of(system))
                _same_plan(got, want, (arch, system, shape, p))


def _stats(arch, seq=512):
    return (TA.stats_for_model(get_config(arch).model, seq),
            JA.stats_for_model(j_get_config(arch).model, seq))


@pytest.mark.parametrize("arch", ("resnet50", "qwen1.5-4b"))
def test_autotune_under_deployment_constraints(arch):
    """A memory cap that forces switches, a fixed model width, a grid, a
    pinned schedule, a strategy subset: the same plan, or the same
    refusal."""
    (ts, js), tcl, jcl = _stats(arch), ClusterSpec.of("paper"), \
        JClusterSpec.of("paper")
    cases = [dict(mem_cap=2e9), dict(mem_cap=2e8), dict(model_width=2),
             dict(model_widths=(1, 2)), dict(model_grid=(2, 2)),
             dict(schedules=("one_f_one_b",)),
             dict(strategies=("filter", "channel", "pipeline")),
             dict(switches=None), dict(fallback="df_zero3"),
             dict(allow_remat=False, allow_pipeline=False)]
    for kw in cases:
        for p in (4, 16):
            res = []
            for A, s, cl, TM in ((TA, ts, tcl, TimeModel),
                                 (JA, js, jcl, JTimeModel)):
                try:
                    res.append(A.autotune(
                        s, TM(cl.system), cl.oracle_config(B=16, D=64), p,
                        cluster=cl, **kw))
                except ValueError as e:
                    res.append(str(e))
            if isinstance(res[1], str):
                assert res[0] == res[1], (kw, p)
            else:
                _same_plan(res[0], res[1], (arch, kw, p))


def test_deployable_masks_match_elementwise():
    for arch in ("resnet50", "qwen1.5-4b", "mamba2-780m"):
        ts, js = _stats(arch)
        for seg, v in ((8, 2), (6, 3)):
            tcfg = ClusterSpec.of("host").oracle_config(
                B=24, D=24, segments=seg, virtual_stages=v)
            jcfg = JClusterSpec.of("host").oracle_config(
                B=24, D=24, segments=seg, virtual_stages=v)
            tres = T_SWEEP.sweep(ts, TimeModel(ClusterSpec.of("host").system),
                                 tcfg, [4, 8, 12], switches="all",
                                 schedules="all")
            jres = J_SWEEP.sweep(js, JTimeModel(JClusterSpec.of(
                "host").system), jcfg, [4, 8, 12], switches="all",
                schedules="all")
            assert len(tres) == len(jres) > 0
            for remat in (True, False):
                np.testing.assert_array_equal(
                    TA.deployable_switch_mask(tres, allow_remat=remat),
                    JA.deployable_switch_mask(jres, allow_remat=remat))
            for ms in (None, 6):
                t = TA.deployable_schedule_mask(tres, tcfg, max_stages=ms)
                np.testing.assert_array_equal(
                    t, JA.deployable_schedule_mask(jres, jcfg,
                                                   max_stages=ms))
                assert not t.all()      # some interleaved points are cut


def test_arch_strategies_match_the_reference():
    for arch in ARCHS + ("resnet152",):
        t, j = get_config(arch), j_get_config(arch)
        assert t.strategy == j.strategy, arch
        assert t.shape_strategy == j.shape_strategy, arch
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert t.strategy_for(shape) == j.strategy_for(shape)
    assert TA.ORACLE_OF_EXEC == JA.ORACLE_OF_EXEC
    assert TA.DEPLOYABLE_STRATEGIES == JA.DEPLOYABLE_STRATEGIES
    assert TA._PREF == JA._PREF
    from repro.configs.base import SHAPES as J_SHAPES
    from repro_torch.configs.base import SHAPES
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}


def test_sweep_takes_rules_table_names():
    """``--strategies`` takes the executable names, mapped as the
    reference maps them; a typo still raises with both sets."""
    names = ("data", "df_zero3", "df", "serve_seqkv", "pipeline", "ep_df")
    assert T_SWEEP._resolve_strategies(names) == \
        J_SWEEP._resolve_strategies(names) == ("data", "df", "ds",
                                               "pipeline", "ep")
    with pytest.raises(ValueError, match="bogus") as e:
        T_SWEEP._resolve_strategies(("df_zero1", "bogus"))
    assert "serve_tp" in str(e.value) and "serial" in str(e.value)


def _run(*args):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "JAX_PLATFORMS": "cpu",
                               "PATH": "/usr/bin:/bin"})


def test_cli_prints_the_reference_table_and_smoke_passes():
    argv = ["--model", "mamba2-780m", "--p", "1..64", "--seq", "1024",
            "--system", "host", "--batch", "8"]
    got = _run("repro_torch.core.autotune", *argv)
    want = _run("repro.core.autotune", *argv)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout and len(got.stdout.splitlines()) == 9
    smoke = _run("repro_torch.core.autotune", "--smoke")
    assert smoke.returncode == 0, smoke.stderr
    assert smoke.stdout.count("autotune --smoke p=") == 2
