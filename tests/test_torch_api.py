"""The port's session (``repro_torch.api.Oracle``) against the reference's
(``repro.api.Oracle``) on the same arguments: every projection, sweep,
advice, serving and tuning call agrees to 1e-12 (0 is expected: the
engines' arithmetic is copied) for ResNet-50, Qwen1.5-4B and Mamba-2 780m
at several p on the ``paper``, ``tpu`` and ``host`` clusters and after
``with_cluster``. The CLI's ``--parity`` gate exits 0; ``.build(None)``'s
cell trains as ``launch/train.py --strategy auto`` does; the measured
methods run on the CPU; what is not ported raises and names its ROADMAP
item."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import Oracle
from repro_torch.data.pipeline import Loader
from repro_torch.launch import train
from repro_torch.launch.build import shard_batch
from repro_torch.nn.module import ShardingCtx
from repro_torch.serve import TrafficModel
from repro_torch.training.steps import train_state

# One torch thread a test process. The suite runs 6 xdist workers on 8
# cores, and every worker imports this file when it collects: at torch's
# default of a thread per core the workers stall each other and the JAX
# package's multi-device subprocesses (a spawned rank sets the same,
# launch/spawn.py).
torch.set_num_threads(1)

ARCHS = ("resnet50", "qwen1.5-4b", "mamba2-780m")
CLUSTERS = ("paper", "tpu", "host")
PS = (1, 4, 64)
REL = 1e-12


def _same(got, want, where=""):
    """Equal field by field: floats (and float arrays) within REL
    relative, everything else exactly."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name),
                  f"{where}.{f.name}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k}]")
    elif isinstance(want, np.ndarray):
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=REL, atol=0,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float):
        assert (got == want or (math.isnan(got) and math.isnan(want))
                or abs(got - want) <= REL * abs(want)), (where, got, want)
    else:
        assert got == want, (where, got, want)


def _same_or_same_error(call, ref_call, where):
    """``_same`` of the two calls' results, or the same error from both
    (the serving tuner refuses a point where nothing is feasible)."""
    try:
        want = ref_call()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(e), where
        return
    _same(call(), want, where)


def _sweep_columns(res):
    return {k: np.asarray(v) for k, v in vars(res).items()
            if isinstance(v, np.ndarray)}


def _sessions(arch, cluster, **kw):
    from repro.api import Oracle as JOracle
    return Oracle(arch, "train_4k", cluster, **kw), \
        JOracle(arch, "train_4k", cluster, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_projections_sweeps_and_advice_equal_the_reference(arch):
    for cluster in CLUSTERS:
        ses, ref = _sessions(arch, cluster, batch=512)
        assert ses.describe() == ref.describe()
        for p in PS:
            for s in ("data", "df", "filter", "spatial"):
                _same(ses.project(s, p), ref.project(s, p), f"{s}@{p}")
            _same(ses.project_all(p), ref.project_all(p), f"all@{p}")
            _same(ses.advise(p), ref.advise(p), f"advise@{p}")
        _same(_sweep_columns(ses.sweep(list(PS))),
              _sweep_columns(ref.sweep(list(PS))), f"sweep {cluster}")


@pytest.mark.parametrize("arch", ARCHS)
def test_tune_equals_the_reference(arch):
    """``tune`` on the default (TPU) cluster and on the three presets, with
    a model width and with the pipeline barred."""
    from repro.api import Oracle as JOracle
    ses, ref = Oracle(arch), JOracle(arch)
    assert ses.cluster == ses.cluster.of("tpu")
    for p in (4, 8, 64):
        _same(ses.tune(p), ref.tune(p), f"tune@{p}")
        _same(ses.tune(p, model_width=2), ref.tune(p, model_width=2))
        _same(ses.tune(p, allow_pipeline=False),
              ref.tune(p, allow_pipeline=False))
    for cluster in CLUSTERS:
        _same(ses.with_cluster(cluster).tune(8),
              ref.with_cluster(cluster).tune(8), f"tune {cluster}")


def test_with_cluster_rebinds_and_keeps_the_rest():
    ses, ref = _sessions("resnet50", "paper", batch=64, overlap=False)
    moved, jmoved = ses.with_cluster("host"), ref.with_cluster("host")
    assert moved.cluster.name == jmoved.cluster.name
    assert moved.B == ses.B == 64 and moved._oracle_kw == {"overlap": False}
    assert ses.cluster.name != moved.cluster.name
    for p in PS:
        _same(moved.project("df", p), jmoved.project("df", p))
        _same(moved.advise(p), jmoved.advise(p))


@pytest.mark.parametrize("arch", ("qwen1.5-4b", "mamba2-780m"))
def test_serving_calls_equal_the_reference(arch):
    from repro.serve.traffic import TrafficModel as JTrafficModel
    traffic = TrafficModel(rate=8.0, prompt_len=512, gen_len=128)
    jtraffic = JTrafficModel(rate=8.0, prompt_len=512, gen_len=128)
    for cluster in CLUSTERS:
        ses, ref = _sessions(arch, cluster)
        for p in (1, 4, 8):
            for s in ("serve_tp", "serve_seqkv"):
                _same(ses.serve_project(traffic, p, strategy=s),
                      ref.serve_project(jtraffic, p, strategy=s),
                      f"{s}@{p}")
            _same(ses.serve_sweep(traffic, p), ref.serve_sweep(jtraffic, p))
            _same_or_same_error(lambda: ses.serve_tune(traffic, p, 30.0),
                                lambda: ref.serve_tune(jtraffic, p, 30.0),
                                f"tune@{p}")


def test_parity_cli_exits_0():
    assert api.main(["--parity"]) == 0


def test_built_cell_trains_as_the_trainer_does():
    """``Oracle.build(None)`` (the host cluster's p = 1 plan for the smoke
    Qwen1.5-4B at batch 2 × 32) gives the losses of ``launch/train.py
    --strategy auto`` on the same batch: one source of truth for the
    cell."""
    ses = Oracle("qwen1.5-4b", "train_4k", "host", smoke=True, batch=2,
                 seq=32)
    cell = ses.build(None, device="cpu")
    ref_plan = ses.tune(1)
    assert cell.meta["plan"] == ref_plan and cell.kind == "train"
    state = train_state(cell.model, cell.meta["opt"], cell.ctx)
    loader = Loader(train.data_config_for(ses.model_cfg, 2, 32),
                    cell.ctx.device)
    losses = []
    for s in range(2):
        state, m = cell.step_fn(state, shard_batch(loader.batch_at(s),
                                                   cell.ctx))
        losses.append(float(m["loss"]))
    out = train.main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "32",
                      "--lr", "3e-4", "--strategy", "auto"])
    assert out["plan"] == ref_plan
    assert losses == out["losses"]


def test_measured_methods_on_the_cpu():
    """``calibrate`` on one device sets the measured compute rate and
    rebinds; ``validate(use_cluster=True)`` projects with it, equal to the
    direct projection; both on the smoke model."""
    from repro_torch.core.oracle import OracleConfig, TimeModel, project
    ses = Oracle("qwen1.5-4b", "train_4k", "host", smoke=True, seq=32)
    spec = ses.calibrate(None, batch_size=2, device="cpu")
    assert ses.cluster == spec and ses.last_measurements == []
    assert spec.peak_flops > 0 and spec.compute_efficiency == 1.0
    assert spec.levels == ses.cluster.of("host").levels
    (pt,) = ses.validate(ShardingCtx("cpu"), ("data",), batch_size=2,
                         use_cluster=True)
    direct = project("data", ses.stats, TimeModel(spec.system),
                     OracleConfig(B=2, D=2), 1)
    assert pt.projected_s == direct.total_s and pt.measured_s > 0


def test_what_is_not_ported_raises_naming_its_item(monkeypatch):
    ses = Oracle("resnet50")
    for call, item in ((lambda: ses.dryrun(), "item 12"),
                       (lambda: ses.roofline_hw(), "item 12"),
                       (lambda: ses.tune_kernels(), "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ses.build(None)
