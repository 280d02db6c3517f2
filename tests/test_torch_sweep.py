"""The port's copy of the sweep engine, the advisor, ClusterSpec and the
sweep CLI against the JAX package's, on the same inputs. The arithmetic is
copied, so arrays agree within 1e-12 relative (0 is expected) and text
output is equal."""
import contextlib
import dataclasses
import importlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core import advisor as j_advisor
from repro.core.cluster import ClusterSpec as JClusterSpec
from repro.core.layer_stats import stats_for as j_stats_for
from repro.core.oracle import OracleConfig as JOracleConfig
from repro.core.oracle import TimeModel as JTimeModel
from repro_torch.configs import get_config
from repro_torch.core import advisor
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.layer_stats import stats_for
from repro_torch.core.oracle import OracleConfig, TimeModel

# the packages (repro.core, repro_torch.core) export the function ``sweep``
# under the name of the subpackage
sweep = importlib.import_module("repro_torch.core.sweep")
j_sweep = importlib.import_module("repro.core.sweep")
ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12
COLUMNS = ("strategy", "p", "p1", "p2", "B", "iterations", "comp_s",
           "comm_ge_s", "comm_fb_s", "comm_halo_s", "comm_p2p_s", "mem_bytes",
           "feasible", "fits", "bottleneck", "limit", "remat", "zero1",
           "zero3", "seq_parallel", "schedule", "p2r", "p2c")


def _paper(arch, B=64):
    cl, jcl = ClusterSpec.of("paper"), JClusterSpec.of("paper")
    return (stats_for(get_config(arch).model), TimeModel(cl.system),
            OracleConfig(B=B, D=1_281_167),
            j_stats_for(j_get_config(arch).model), JTimeModel(jcl.system),
            JOracleConfig(B=B, D=1_281_167))


def _same_columns(res, jres):
    assert len(res) == len(jres) > 0
    for col in COLUMNS:
        got, want = np.asarray(getattr(res, col)), np.asarray(getattr(jres, col))
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=REL, atol=0,
                                       err_msg=col)
        else:
            np.testing.assert_array_equal(got, want, err_msg=col)


@pytest.mark.parametrize("arch", ["resnet50", "vgg16", "cosmoflow"])
def test_sweep_equals_the_reference(arch):
    """All strategies × p = 1..1024 (powers of two) × every p1·p2 split ×
    all 16 memory-switch combinations × the three pipeline schedules, with
    weak scaling (B = 2p) and the paper preset's memory cap."""
    stats, tm, cfg, jstats, jtm, jcfg = _paper(arch)
    grid = sweep.parse_p_grid("1..1024")
    kw = dict(batch_for_p=lambda p: 2 * p, mem_cap=16e9, switches="all",
              schedules="all")
    res = sweep.sweep(stats, tm, cfg, grid, **kw)
    jres = j_sweep.sweep(jstats, jtm, jcfg, grid, **kw)
    _same_columns(res, jres)
    assert res.crossover("data", "df") == jres.crossover("data", "df")
    assert res.table() == jres.table()
    _same_columns(res.pareto(), jres.pareto())


def test_advise_equals_the_reference():
    for arch in ("resnet50", "vgg16", "cosmoflow"):
        stats, tm, cfg, jstats, jtm, jcfg = _paper(arch, B=256)
        for p in (8, 64, 512):
            rec = advisor.advise(stats, tm, cfg, p)
            jrec = j_advisor.advise(jstats, jtm, jcfg, p)
            assert [dataclasses.astuple(r) for r in rec.ranked] == \
                [dataclasses.astuple(r) for r in jrec.ranked], (arch, p)
            assert [(dataclasses.astuple(r), why) for r, why in rec.rejected] \
                == [(dataclasses.astuple(r), why) for r, why in jrec.rejected]
            assert advisor.breakdown_table(rec.ranked) == \
                j_advisor.breakdown_table(jrec.ranked)
            groups = advisor.advise_groups(stats, tm, cfg, p)
            jgroups = j_advisor.advise_groups(jstats, jtm, jcfg, p)
            assert [dataclasses.astuple(g) for g in groups] == \
                [dataclasses.astuple(g) for g in jgroups]


def test_cluster_fit_artifact_reads_the_same():
    """experiments/cluster_fit.json (read, not written): the same spec,
    fingerprint and JSON; its raw measurements refit to the same spec."""
    path = str(ROOT / "experiments" / "cluster_fit.json")
    spec, jspec = ClusterSpec.from_json(path), JClusterSpec.from_json(path)
    assert spec.fingerprint() == jspec.fingerprint()
    assert spec.to_json() == jspec.to_json()
    assert ClusterSpec.from_json(spec.to_json()) == spec
    assert spec.describe() == jspec.describe()
    ms = json.loads(Path(path).read_text())["measurements"]
    fit = ClusterSpec.fitted_from(ms, base="host")
    jfit = JClusterSpec.fitted_from(ms, base="host")
    assert fit.to_json() == jfit.to_json()
    for name in ("paper", "tpu", "host"):
        assert ClusterSpec.of(name).to_json() == JClusterSpec.of(name).to_json()
        assert ClusterSpec.of(name).fingerprint() == \
            JClusterSpec.of(name).fingerprint()


def _cli(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("argv", [
    ["--model", "vgg16", "--p", "1..256"],
    ["--model", "cosmoflow", "--p", "4..64", "--batch-per-pe", "0.25",
     "--crossover", "spatial", "ds", "--no-overlap"],
    ["--model", "resnet50", "--p", "1..64", "--csv", "--system", "tpu",
     "--phi", "data=1.5", "--sigma", "model=0.5", "--zero1"],
    ["--model", "qwen1.5-4b", "--p", "8,16", "--seq", "2048",
     "--strategies", "data,df,pipeline"]])
def test_sweep_cli_prints_the_reference_text(argv):
    assert _cli(sweep.main, argv) == _cli(j_sweep.main, argv)


def test_sweep_cli_smoke_and_unknown_strategy():
    assert "sweep --smoke OK" in _cli(sweep.main, ["--smoke"])
    with pytest.raises(SystemExit):
        sweep.main(["--model", "resnet50", "--strategies", "data,bogus"])
    with pytest.raises(ValueError, match="bogus"):
        sweep._resolve_strategies(("data", "bogus"))
    assert sweep._resolve_strategies(("data", "df", "data")) == ("data", "df")
