"""The logical axes of the port's LMs and the oracle's LM rows at p = 4,
without ranks.

Every parameter of the port's Qwen1.5-4B and Mamba-2 780m, smoke and full
(the full trees on ``meta``), records the axes of the reference's
``params_spec()`` leaf for leaf, matched by the bridge's names: the
reference stacks its layers on a leading "layers" axis, which the port's
per-layer blocks drop. ``shard_params`` places a parameter by those axes,
so a wrong one splits it on the wrong rule (the SSD's gated norm over
d_inner is on "mlp", not "embed").

``validate``'s projections for the smoke Qwen at p = 4 under the six
strategies, with a fixed ClusterSpec and the measured step stubbed out,
equal the reference's ``project`` over ``stats_for(cfg, S)`` (1e-12
relative, 0 expected): ``S`` reaches the LM's layer stats, df and ds take
the mesh's (p1, p2), spatial is projected as pure spatial parallelism.
"""
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.hardware import Level as JLevel
from repro.core.hardware import SystemModel as JSystemModel
from repro.core.layer_stats import stats_for as j_stats_for
from repro.core.oracle import OracleConfig as JOracleConfig
from repro.core.oracle import TimeModel as JTimeModel
from repro.core.oracle import project as j_project
from repro.models.transformer import TransformerLM as JLM
from repro_torch.bridge import flatten
from repro_torch.configs import get_config
from repro_torch.core import validation
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.hardware import Level, SystemModel
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx

ARCHS = ("qwen1.5-4b", "mamba2-780m")
META = torch.device("meta")
STRATEGIES = ("data", "filter", "channel", "spatial", "df", "ds")


def _reference_axes(jcfg) -> dict:
    """{port parameter name: logical axes} of the reference's spec tree,
    its stacked layers unstacked."""
    leaves = flatten(JLM(jcfg).params_spec())
    period = len(jcfg.pattern)
    out = {}
    for k, spec in leaves.items():
        if not k.startswith("stacks."):
            out[k] = tuple(spec.axes)
            continue
        _, pos, rest = k.split(".", 2)
        assert spec.axes[0] == "layers", (k, spec.axes)
        for g in range(spec.shape[0]):
            out[f"blocks.{g * period + int(pos)}.{rest}"] = tuple(
                spec.axes[1:])
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_records_the_reference_axes(arch, smoke):
    jcfg = j_get_config(arch)
    jcfg = jcfg.smoke_model if smoke else jcfg.model
    cfg = get_config(arch)
    model = TransformerLM(cfg.smoke_model if smoke else cfg.model,
                          device=META, generator=None)
    got = {k: getattr(p, "axes", None) for k, p in model.named_parameters()}
    assert got == _reference_axes(jcfg)


def test_the_ssd_norm_scale_is_on_mlp():
    """The gated norm over d_inner: "mlp", as the reference's
    ``RMSNorm(c.d_inner, axis_name="mlp")``; the block norms on "embed"."""
    model = TransformerLM(get_config("mamba2-780m").model, device=META,
                          generator=None)
    for i, block in enumerate(model.blocks):
        assert block.mixer.norm.scale.axes == ("mlp",), i
        assert block.norm1.scale.axes == ("embed",), i
    assert model.final_norm.scale.axes == ("embed",)


class _Mesh:
    """A (2, 2) mesh as ``validate`` reads one (no ranks)."""
    shape = {"data": 2, "model": 2}
    size, rank, device = 4, 0, torch.device("cpu")


@pytest.mark.parametrize("S", [32, 128])
def test_validate_projects_the_lm_rows_as_the_reference(monkeypatch, S):
    cfg = get_config("qwen1.5-4b").smoke_model
    jcfg = j_get_config("qwen1.5-4b").smoke_model
    measured = []
    monkeypatch.setattr(validation, "measure_step",
                        lambda *a, **k: measured.append(a[3]) or 0.5)
    lvl = ("shm", 2e-5, 1 / 9e9)
    sysm = SystemModel("probe", 3e11, 2e11, 4e9, 0.7, tuple(
        (ax, Level(*lvl)) for ax in ("model", "data", "pod")))
    jsysm = JSystemModel("probe", 3e11, 2e11, 4e9, 0.7, tuple(
        (ax, JLevel(*lvl)) for ax in ("model", "data", "pod")))
    cluster = ClusterSpec.from_system(sysm, phi=(("data", 1.5),),
                                      sigma=(("data", 0.5),))
    B = 8
    flops = float(sum(s.flops_fwd for s in j_stats_for(jcfg, S)))
    pts = validation.validate(
        None, cfg, None, ShardingCtx("cpu", mesh=_Mesh()), STRATEGIES,
        flops_per_sample=flops, B=B, S=S, cluster=cluster)
    assert [pt.strategy for pt in pts] == list(STRATEGIES) == measured
    kw = dict(B=B, D=B, phi_levels=(("data", 1.5),),
              sigma_levels=(("data", 0.5),))
    jstats, jtm = j_stats_for(jcfg, S), JTimeModel(jsysm)
    for pt in pts:
        assert pt.p == 4 and pt.measured_s == 0.5
        pkw = dict(p1=2, p2=2) if pt.strategy in ("df", "ds") else {}
        for got, overlap in ((pt.projected_s, True),
                             (pt.projected_serial_s, False)):
            want = j_project(pt.strategy, jstats, jtm,
                             JOracleConfig(overlap=overlap, **kw), 4,
                             **pkw).total_s
            assert abs(got - want) <= 1e-12 * want, (pt.strategy, overlap)
