"""The port's pipeline rules (``repro_torch.parallel.schedules``) held
against the JAX package without ranks: the block count, the per-block costs
over the oracle's layer stats (to 1e-12), the min-max cuts and the stage
boundary shapes of ResNet-50/152, VGG16 and CosmoFlow at full width (on the
``meta`` device) and at smoke width, and the cuts the train step makes on
those costs; ``clip_segments``/``resolve_segments`` with their warnings
and errors; the oracle's schedule winner. Also: the
blocks composed in order are the model's forward; each schedule's action
lists run to their end when every receive blocks (no deadlock), every
transfer has one sender and one receiver, the sends between two ranks come
in the order their receiver takes them, and 1F1B keeps at most p − r
microbatches live on rank r; an unknown schedule, p·v above the block
count (an LM's blocks are its layers) and S % p ≠ 0 under interleaved
each raise, and the trainer refuses ``--accum > 1`` under ``--strategy
pipeline``.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.hardware import PAPER_V100_CLUSTER as J_V100
from repro.core.layer_stats import stats_for as j_stats_for
from repro.core.oracle import OracleConfig as JOracleConfig
from repro.core.oracle import TimeModel as JTimeModel
from repro.core.partition import min_max_partition as j_min_max_partition
from repro.core.validation import schedule_winner as j_schedule_winner
from repro.models import cnn as jcnn
from repro.nn.module import tree_abstract
from repro.parallel.schedules import hetero as jhetero
from repro.parallel.schedules import runtime as jruntime
from repro.parallel.schedules import train_step as jtrain_step
from repro_torch.configs import get_config
from repro_torch.core.hardware import PAPER_V100_CLUSTER
from repro_torch.core.layer_stats import stats_for
from repro_torch.core.oracle import PIPELINE_SCHEDULES, OracleConfig, TimeModel
from repro_torch.core.partition import min_max_partition
from repro_torch.core.validation import schedule_winner
from repro_torch.launch import train
from repro_torch.launch.mesh import Group
from repro_torch.models import cnn
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel.schedules import (
    SCHEDULE_NAMES, SCHEDULES, boundary_shapes, clip_segments,
    make_pipeline_train_step, model_pipe_blocks, pipeline_block_costs,
    pipeline_block_count, pipeline_supported, resolve_segments)
from repro_torch.parallel.schedules.hetero import meta_twin
from repro_torch.parallel.schedules.runtime import (
    StageProgram, gpipe_actions, interleaved_actions, one_f_one_b_actions)

META = torch.device("meta")
# name → (port config, reference config, per-sample input shape)
FULL = {
    "resnet50": (cnn.RESNET50, jcnn.RESNET50, (224, 224, 3)),
    "resnet152": (cnn.RESNET152, jcnn.RESNET152, (224, 224, 3)),
    "vgg16": (cnn.VGGConfig(), jcnn.VGGConfig(), (224, 224, 3)),
    "cosmoflow": (cnn.CosmoFlowConfig(img=128), jcnn.CosmoFlowConfig(img=128),
                  (128, 128, 128, 4)),
}
SMOKE = {
    "resnet_1111": (cnn.ResNetConfig("r", (1, 1, 1, 1), n_classes=10),
                    jcnn.ResNetConfig("r", (1, 1, 1, 1), n_classes=10),
                    (32, 32, 3)),
    "resnet_2222": (cnn.ResNetConfig("r", (2, 2, 2, 2), n_classes=10),
                    jcnn.ResNetConfig("r", (2, 2, 2, 2), n_classes=10),
                    (64, 64, 3)),
    "vgg16": (cnn.VGGConfig(name="v", n_classes=10, img=32),
              jcnn.VGGConfig(name="v", n_classes=10, img=32), (32, 32, 3)),
    "cosmoflow": (cnn.CosmoFlowConfig(img=16, n_conv=3, width=8),
                  jcnn.CosmoFlowConfig(img=16, n_conv=3, width=8),
                  (16, 16, 16, 4)),
}
PORT_MODEL = {cnn.ResNetConfig: cnn.ResNet, cnn.VGGConfig: cnn.VGG,
              cnn.CosmoFlowConfig: cnn.CosmoFlow}
JAX_MODEL = {jcnn.ResNetConfig: jcnn.ResNet, jcnn.VGGConfig: jcnn.VGG,
             jcnn.CosmoFlowConfig: jcnn.CosmoFlow}


def _port(cfg, device=META, seed=None):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return PORT_MODEL[type(cfg)](cfg, device=device, generator=gen)


def _jax(jcfg):
    return JAX_MODEL[type(jcfg)](jcfg)


def test_block_count_matches_the_reference():
    """pipeline_block_count for every CNN, smoke and full, and the LMs."""
    for tc, jc, _ in list(FULL.values()) + list(SMOKE.values()):
        assert pipeline_block_count(tc) == jhetero.pipeline_block_count(jc)
        assert pipeline_block_count(tc) == len(model_pipe_blocks(_port(tc)))
    for arch in ("qwen1.5-4b", "mamba2-780m"):
        assert pipeline_block_count(get_config(arch).model) == \
            jhetero.pipeline_block_count(j_get_config(arch).model)
    assert pipeline_block_count(object()) is None


@pytest.mark.parametrize("arch", list(FULL))
def test_block_costs_match_the_reference(arch):
    """Names and fw+bw costs of the blocks over stats_for, to 1e-12; no
    stats gives uniform costs; the blocks' parameters cover the model's,
    each once."""
    tc, jc, _ = FULL[arch]
    model, jmodel = _port(tc), _jax(jc)
    got = pipeline_block_costs(model, stats_for(tc))
    want = jhetero.pipeline_block_costs(jmodel, j_stats_for(jc))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert [b.name for b in model_pipe_blocks(model)] == \
        [b.name for b in jhetero.model_pipe_blocks(jmodel)]
    np.testing.assert_array_equal(pipeline_block_costs(model),
                                  np.ones(len(got)))
    owned = [k for b in model_pipe_blocks(model) for k in b.params]
    assert sorted(owned) == sorted(k for k, _ in model.named_parameters())


def test_partition_cuts_match_the_reference():
    """min_max_partition's cuts of every model's block costs into every
    chunk count from 1 to the block count; and the train step cuts the
    smoke models into p·v chunks where min_max_partition puts them over
    the reference's block costs on its layer stats (not uniform costs)."""
    for tc, jc, _ in FULL.values():
        costs = pipeline_block_costs(_port(tc), stats_for(tc))
        jcosts = jhetero.pipeline_block_costs(_jax(jc), j_stats_for(jc))
        for k in range(1, len(costs) + 1):
            assert min_max_partition(costs, k).bounds == \
                j_min_max_partition(jcosts, k).bounds, (tc.name, k)
    ctx = ShardingCtx("cpu", mesh=_StubMesh())
    opt = OptimizerConfig(name="sgd")
    for name, schedule, v in (("resnet_2222", "interleaved", 2),
                              ("resnet_1111", "gpipe", 1),
                              ("vgg16", "one_f_one_b", 1)):
        tc, jc, _ = SMOKE[name]
        jcosts = jhetero.pipeline_block_costs(_jax(jc), j_stats_for(jc))
        assert len(set(jcosts)) > 1, name
        step = make_pipeline_train_step(_port(tc), opt, ctx,
                                        schedule=schedule, virtual_stages=v)
        assert step.bounds == j_min_max_partition(jcosts, 4 * v).bounds, \
            name


def test_boundary_shapes_match_the_reference():
    """The per-sample shapes entering each block (and leaving the last), on
    ``meta`` here and by ``jax.eval_shape`` in the reference."""
    for tc, jc, shape in list(FULL.values()) + list(SMOKE.values()):
        got = boundary_shapes(model_pipe_blocks(meta_twin(_port(tc))),
                              torch.empty((1,) + shape, device=META))
        jmodel = _jax(jc)
        want = jhetero.boundary_shapes(
            jhetero.model_pipe_blocks(jmodel),
            tree_abstract(jmodel.params_spec()),
            jax.ShapeDtypeStruct((1,) + shape, np.float32))
        assert got == want, (tc.name, got, want)


def test_blocks_compose_to_the_forward():
    """The smoke models' blocks applied in order give the model's forward,
    bit for bit."""
    ctx = ShardingCtx("cpu")
    gen = torch.Generator().manual_seed(0)
    for tc, _, shape in SMOKE.values():
        model = _port(tc, torch.device("cpu"), seed=0)
        x = torch.randn((3,) + shape, generator=gen)
        h = x
        with torch.no_grad():
            for blk in model_pipe_blocks(model):
                h = blk.apply(h)
            assert torch.equal(h, model(x, ctx)), tc.name


def test_segments_clip_warn_and_raise_as_the_reference():
    """clip_segments and resolve_segments over a grid of batches, requests
    and multiples: the same S, a warning exactly when S < the request, and
    the same ValueError where no S fits."""
    for batch in range(1, 18):
        for seg in range(1, 11):
            assert clip_segments(batch, seg) == \
                jtrain_step.clip_segments(batch, seg)
            for mult in (1, 2, 4):
                with warnings.catch_warnings(record=True) as got_w:
                    warnings.simplefilter("always")
                    try:
                        got = resolve_segments(batch, seg, mult)
                    except ValueError as e:
                        got = ("raises", "S % p == 0" in str(e))
                with warnings.catch_warnings(record=True):
                    warnings.simplefilter("always")
                    try:
                        want = jtrain_step.resolve_segments(batch, seg, mult)
                    except ValueError:
                        want = ("raises", True)
                assert got == want, (batch, seg, mult)
                warned = any("clipped" in str(w.message) for w in got_w)
                assert warned == (not isinstance(got, tuple) and got < seg)


def test_schedule_names_and_the_oracles_winner():
    """The executors' names are the oracle's schedule axis and the
    reference's; schedule_winner picks what the reference's picks."""
    assert SCHEDULE_NAMES == PIPELINE_SCHEDULES == jruntime.SCHEDULE_NAMES
    assert tuple(SCHEDULES) == SCHEDULE_NAMES
    for arch in ("resnet50", "vgg16", "cosmoflow"):
        tc, jc, _ = FULL[arch]
        for p in (2, 4, 8):
            cfg = dict(B=32, D=32, segments=8, virtual_stages=2)
            assert schedule_winner(
                stats_for(tc), TimeModel(PAPER_V100_CLUSTER),
                OracleConfig(**cfg), p) == j_schedule_winner(
                j_stats_for(jc), JTimeModel(J_V100), JOracleConfig(**cfg), p)


def _simulate(actions: dict, n_chunks: int, p: int) -> dict:
    """Runs every rank's action list with non-blocking sends and blocking
    receives until all end; raises on a deadlock. Returns the transfers in
    the order each was sent and taken, per (sender, receiver), and each
    rank's peak count of live (forwarded, not yet backwarded) microbatches.
    """
    last = n_chunks - 1
    sent, pos = set(), {r: 0 for r in actions}
    order = {"send": {}, "recv": {}}
    live = {r: 0 for r in actions}
    peak = dict(live)
    while any(pos[r] < len(actions[r]) for r in actions):
        moved = False
        for r, acts in actions.items():
            while pos[r] < len(acts):
                kind, j, m = acts[pos[r]]
                if kind == "F":
                    need = ("act", j, m) if j > 0 else None
                    src = (j - 1) % p
                    out = (("act", j + 1, m), (j + 1) % p) if j < last \
                        else None
                else:
                    need = ("grad", j + 1, m) if j < last else None
                    src = (j + 1) % p
                    out = (("grad", j, m), (j - 1) % p) if j > 0 else None
                if need is not None and need not in sent:
                    break
                if need is not None:
                    order["recv"].setdefault((src, r), []).append(need)
                if out is not None:
                    assert out[0] not in sent, out
                    sent.add(out[0])
                    order["send"].setdefault((r, out[1]), []).append(out[0])
                assert j % p == r
                live[r] += 1 if kind == "F" else -1
                peak[r] = max(peak[r], live[r])
                pos[r] += 1
                moved = True
        if not moved:
            raise AssertionError(f"deadlock at {pos}")
    return {"order": order, "peak": peak}


@pytest.mark.parametrize("schedule", SCHEDULE_NAMES)
def test_schedules_run_without_deadlock_in_order(schedule):
    for p in (1, 2, 4):
        for S in range(1, 9):
            for v in ((1, 2, 3) if schedule == "interleaved" else (1,)):
                if schedule == "interleaved" and S % p:
                    continue
                acts = {r: (gpipe_actions(r, p, S) if schedule == "gpipe"
                            else one_f_one_b_actions(r, p, S)
                            if schedule == "one_f_one_b"
                            else interleaved_actions(r, p, S, v))
                        for r in range(p)}
                n_chunks = p * v
                for r, a in acts.items():     # every chunk of r: F then B
                    assert sorted(a) == sorted(
                        (k, j, m) for k in "FB" for j in range(r, n_chunks, p)
                        for m in range(S))
                sim = _simulate(acts, n_chunks, p)
                order = sim["order"]
                assert order["send"] == order["recv"], (p, S, v)
                for r, peak in sim["peak"].items():
                    want = {"gpipe": S, "one_f_one_b": min(p - r, S),
                            "interleaved": v * S}[schedule]
                    assert peak == want, (schedule, p, S, v, r, peak)


class _StubMesh:
    """The shape and stage group of a (1, 4) mesh, with no ranks behind
    it: the step's checks run before any transfer."""
    shape = {"data": 1, "model": 4}
    size = 4
    device = torch.device("cpu")

    def group(self, axes):
        return Group(None, (0, 1, 2, 3), 0, False)


def test_unknown_schedule_deep_pipes_bad_segments_and_the_lm_raise():
    opt = OptimizerConfig(name="sgd")
    ctx = ShardingCtx("cpu", mesh=_StubMesh())
    cosmo = _port(cnn.CosmoFlowConfig(img=16, n_conv=2, width=8))
    resnet = _port(SMOKE["resnet_1111"][0])
    with pytest.raises(ValueError, match="unknown schedule 'zigzag'"):
        make_pipeline_train_step(resnet, opt, ctx, schedule="zigzag")
    with pytest.raises(ValueError, match="4 stages × 1 virtual exceed 3"):
        make_pipeline_train_step(cosmo, opt, ctx)
    with pytest.raises(ValueError, match="4 stages × 2 virtual exceed 6"):
        make_pipeline_train_step(resnet, opt, ctx, schedule="interleaved")
    with pytest.raises(ValueError, match="a 'model' axis"):
        make_pipeline_train_step(resnet, opt, ShardingCtx("cpu"))
    program = StageProgram(_StubMesh().group("model"), 8, None, None, None,
                           None, torch.device("cpu"))
    with pytest.raises(ValueError, match="S % p == 0"):
        SCHEDULES["interleaved"](program, 6)
    lm = TransformerLM(get_config("qwen1.5-4b").smoke_model, device=META,
                       generator=None)
    assert pipeline_supported(lm) is None
    assert pipeline_supported(resnet) is None
    with pytest.raises(ValueError, match="4 stages × 1 virtual exceed 2"):
        make_pipeline_train_step(lm, opt, ctx)
    assert [b.name for b in model_pipe_blocks(lm)] == ["L0.attn", "L1.attn"]
    with pytest.raises(SystemExit, match="--accum > 1"):
        train.main(["--arch", "resnet50", "--smoke", "--device", "cpu",
                    "--strategy", "pipeline", "--accum", "2"])
