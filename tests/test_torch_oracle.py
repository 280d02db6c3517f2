"""The port's copy of the oracle core against the JAX package's, on the same
inputs: the layer tables (``stats_for``) of the four CNNs at their full
configs and of Qwen1.5-4B and Mamba-2 780m at S = 4096, and ``project`` for
every strategy over a p grid, under the named presets and the memory-model
switches. The arithmetic is copied, so the bar is 1e-12 relative and 0 is
expected."""
import dataclasses

import pytest

from repro.configs import get_config as j_get_config
from repro.core import hardware as j_hw
from repro.core import oracle as j_oracle
from repro.core.layer_stats import stats_for as j_stats_for
from repro_torch.configs import get_config
from repro_torch.core import hardware, oracle
from repro_torch.core.layer_stats import stats_for
from repro_torch.models.transformer import LMConfig

ARCHS = ("resnet50", "resnet152", "vgg16", "cosmoflow", "qwen1.5-4b",
         "mamba2-780m")
P_GRID = (1, 2, 4, 8, 16, 64, 256, 1024)
REL = 1e-12


def _stats(arch):
    return (stats_for(get_config(arch).model, 4096),
            j_stats_for(j_get_config(arch).model, 4096))


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("arch", ARCHS)
def test_stats_for_equals_the_reference(arch):
    got, want = _stats(arch)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert gd.keys() == wd.keys()
        for k in gd:
            if isinstance(gd[k], float):
                assert _rel(gd[k], wd[k]) <= REL, (g.name, k)
            else:
                assert gd[k] == wd[k], (g.name, k)
        assert g.flops_bwd == w.flops_bwd


def _configs(B):
    kw = dict(B=B, D=1_281_167)
    yield kw
    yield dict(kw, overlap=False)
    yield dict(kw, remat=True, zero1=True, seq_parallel=True)
    yield dict(kw, zero3=True, schedule="one_f_one_b", segments=4)
    yield dict(kw, schedule="interleaved", virtual_stages=2,
               phi_levels=(("data", 1.5),), sigma_levels={"model": 0.5})


def _fields(pr):
    return {f.name: getattr(pr, f.name) for f in dataclasses.fields(pr)}


@pytest.mark.parametrize("arch", ARCHS)
def test_project_equals_the_reference(arch):
    """Every strategy of STRATEGY_NAMES at every p of the grid (hybrids at
    their default and at an explicit split), under the paper and TPU
    presets and five OracleConfigs, and ``project_all`` on the host preset;
    every field of the Projection."""
    assert oracle.STRATEGY_NAMES == j_oracle.STRATEGY_NAMES
    stats, jstats = _stats(arch)
    n = 0
    for name in ("PAPER_V100_CLUSTER", "TPU_V5E_POD"):
        sysm, jsysm = getattr(hardware, name), getattr(j_hw, name)
        assert dataclasses.astuple(sysm) == dataclasses.astuple(jsysm)
        tm, jtm = oracle.TimeModel(sysm), j_oracle.TimeModel(jsysm)
        for kw in _configs(B=256):
            cfg, jcfg = oracle.OracleConfig(**kw), j_oracle.OracleConfig(**kw)
            for s in oracle.STRATEGY_NAMES:
                for p in P_GRID:
                    splits = [{}]
                    if s in ("df", "ds", "ep", "summa") and p >= 4:
                        splits.append(dict(p1=2, p2=p // 2))
                    for sp in splits:
                        try:
                            want = _fields(j_oracle.project(s, jstats, jtm,
                                                            jcfg, p, **sp))
                        except ValueError as e:
                            with pytest.raises(ValueError, match=str(e)):
                                oracle.project(s, stats, tm, cfg, p, **sp)
                            continue
                        got = _fields(oracle.project(s, stats, tm, cfg, p,
                                                     **sp))
                        for k, v in want.items():
                            if isinstance(v, float):
                                assert _rel(got[k], v) <= REL, (s, p, sp, k)
                            else:
                                assert got[k] == v, (s, p, sp, k)
                        n += 1
    assert n > 500
    host = oracle.project_all(stats, oracle.TimeModel(hardware.cpu_host_model()),
                              oracle.OracleConfig(B=8, D=64), 1)
    jhost = j_oracle.project_all(jstats,
                                 j_oracle.TimeModel(j_hw.cpu_host_model()),
                                 j_oracle.OracleConfig(B=8, D=64), 1)
    assert [_fields(a) for a in host] == [_fields(b) for b in jhost]


def test_seq_flops_coeffs_equal_the_reference():
    for arch in ("qwen1.5-4b", "mamba2-780m"):
        got = oracle.seq_flops_coeffs(get_config(arch).model, 2048)
        want = j_oracle.seq_flops_coeffs(j_get_config(arch).model, 2048)
        assert all(_rel(g, w) <= REL for g, w in zip(got, want)), arch


def test_lm_stats_of_an_unported_block_kind_raise():
    cfg = dataclasses.replace(get_config("qwen1.5-4b").smoke_model,
                              pattern=("attn", "moe"))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        stats_for(cfg, 64)
    assert isinstance(cfg, LMConfig)
    with pytest.raises(TypeError, match="no layer stats"):
        stats_for(object())
