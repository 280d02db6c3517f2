"""The LM pipeline (``parallel/schedules`` on an LM) on 4 gloo ranks on the
CPU, all 4 the stages of a (1, 4) mesh, against the port's serial step
from the same weights (seed 0) and tokens; and the reference's own
pipeline step as a witness.

* The stage helpers (``stages.py``) give the layers the reference's padded
  layouts hold (its ``idx`` where its ``mask`` is set) for uneven cuts,
  plain and interleaved, and ``block_costs_from_stats`` equals the
  reference's on the same stats; an LM's blocks are its layers.
* The bridge loads the reference's mixed ``("ssm", "attn")`` 5-layer LM,
  whose fifth layer lives in the tree's ``tail``; the port's forward and
  loss then match the reference's at the single-device LM bars (logits
  1e-4, loss 1e-6 relative).
* One SGD step (clipping off) per case, fp32 smoke widths (d 64; batch
  8 × 32, S = 4): the uniform Qwen at 8 layers under gpipe, one_f_one_b
  and interleaved (v = 2), uneven cuts at 5 layers (one_f_one_b) and 10
  (interleaved, 8 chunks), the tied Mamba (its table read by both ends)
  under gpipe, the mixed LM cut on its per-layer costs from the oracle's
  stats (attention and SSD layers cost differently), and a masked batch.
  Bars: the loss within 1e-5 relative, the updated parameters within 1e-4
  in relative L2 over the whole model, the clipping norm within 1e-5; the
  CPU reads ~1e-7, ~1e-9 and ~1e-7. After ``gather_pipeline_state`` every
  rank holds the same parameters; a tied table is updated alike on the
  first and the last stage before it.
* The trainer (``launch.train.main --strategy pipeline``) trains the
  published bf16 smoke Mamba across the ranks; its first loss is the
  single-process trainer's within 1e-5. ``validate`` measures the LM's
  pipeline row (cut on its stats at the batch's sequence length) and
  projects it as ``project`` does; ``measure_schedule_bubble`` fits an
  LM's schedule; ``schedule_winner`` takes LM stats.
* Witness: the JAX package's ``make_pipeline_train_step`` on a (1, 4) mesh
  of 4 virtual host devices, in a subprocess (``python <this file>
  <out.npz>``): its stacked path (the uniform Qwen at 10 layers, uneven
  cuts, one_f_one_b) and its switch path (the mixed LM with its ``tail``,
  gpipe). Its loss and updated parameters against the port's serial step
  on the reference's weights at the bars above.
"""
import contextlib
import dataclasses
import io
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bridge import _unstack_layers, flatten, load_jax_params
from repro_torch.configs import get_config
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.layer_stats import stats_for
from repro_torch.core.partition import min_max_partition
from repro_torch.core.oracle import OracleConfig, TimeModel, project
from repro_torch.core.validation import (measure_schedule_bubble,
                                         schedule_winner, validate)
from repro_torch.launch import train
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.parallel.schedules import (
    block_costs_from_stats, gather_pipeline_state, make_pipeline_train_step,
    model_pipe_blocks, pipeline_block_costs, stack_stage_bounds,
    stack_virtual_stage_bounds)
from repro_torch.training.steps import make_train_step, train_state

B, SEQ, SEG, CHUNK, LR = 8, 32, 4, 8, 3e-3
CPU = ShardingCtx("cpu")
OPT = OptimizerConfig(name="sgd", lr=LR, grad_clip=1e9)
# (model, layers, schedule, interleaved v, masked batch, cut on stats)
CASES = [("qwen", 8, "gpipe", 1, False, False),
         ("qwen", 8, "one_f_one_b", 1, False, False),
         ("qwen", 8, "interleaved", 2, False, False),
         ("qwen", 5, "one_f_one_b", 1, False, False),
         ("qwen", 10, "interleaved", 2, False, False),
         ("mamba", 4, "gpipe", 1, False, False),
         ("mixed", 5, "gpipe", 1, False, True),
         ("qwen", 8, "gpipe", 1, True, False)]
# the witness: (model, layers, schedule)
WITNESS = [("qwen", 10, "one_f_one_b"), ("mixed", 5, "gpipe")]
TRAIN_ARGS = ["--arch", "mamba2-780m", "--smoke", "--steps", "1", "--batch",
              str(B), "--seq", str(SEQ), "--device", "cpu"]


def _fp32(cfg, **kw):
    cfg = dataclasses.replace(cfg, **kw)
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=torch.float32)
           for k in ("attn", "ffn", "ssm") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=torch.float32, **sub)


def _cfg(kind, layers, get=get_config, fp32=_fp32):
    """The fp32 smoke config of ``kind`` at ``layers`` (``get``/``fp32``:
    the reference's, for its twin): the Qwen, the tied Mamba, or the Qwen
    with the Mamba's SSD blocks at even layers."""
    if kind == "mamba":
        return fp32(get("mamba2-780m").smoke_model, n_layers=layers)
    qwen = get("qwen1.5-4b").smoke_model
    if kind == "qwen":
        return fp32(qwen, n_layers=layers)
    return fp32(qwen, n_layers=layers, pattern=("ssm", "attn"),
                ssm=get("mamba2-780m").smoke_model.ssm)


def _model(kind, layers):
    return TransformerLM(_cfg(kind, layers), device=torch.device("cpu"),
                         generator=torch.Generator().manual_seed(0))


def _tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 512, (B, SEQ)).astype(
        np.int32)


def _batch(masked=False) -> dict:
    batch = {"tokens": torch.from_numpy(_tokens()).long()}
    if masked:
        gen = torch.Generator().manual_seed(2)
        batch["mask"] = (torch.rand(B, SEQ, generator=gen) > 0.4).float()
    return batch


def _rel_l2(got, want):
    num = sum(float((got[k].double() - want[k].double()).square().sum())
              for k in want)
    return (num / sum(float(want[k].double().square().sum())
                      for k in want)) ** 0.5


def _costs(model):
    return pipeline_block_costs(model, stats_for(model.cfg, SEQ))


def _serial(kind, layers, masked, params=None):
    """The port's serial SGD step: (loss, grad norm, updated parameters)."""
    model = _model(kind, layers)
    if params is not None:
        load_jax_params(model, params)
    state, m = make_train_step(model, OPT, CPU, q_chunk=CHUNK,
                               kv_chunk=CHUNK)(train_state(model, OPT),
                                               _batch(masked))
    return float(m["loss"]), float(m["grad_norm"]), {
        k: p.detach().clone() for k, p in state["params"].items()}


def _case(mesh, kind, layers, schedule, v, masked, costs):
    model = _model(kind, layers)
    step = make_pipeline_train_step(
        model, OPT, ShardingCtx("cpu", mesh=mesh), segments=SEG,
        schedule=schedule, virtual_stages=v, q_chunk=CHUNK, kv_chunk=CHUNK,
        block_costs=_costs(model) if costs else None)
    state, m = step(train_state(model, OPT), _batch(masked))
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "S": m["pipeline_segments"], "bounds": step.bounds,
           "shared": dict(step.shared),
           "table": model.embed.table.detach().clone()}
    gather_pipeline_state(state, step)
    out["params"] = {k: p.detach().clone()
                     for k, p in model.named_parameters()}
    return out


def _ranks(mesh22):
    mesh = mesh22.regrid(1, 4)
    rank0 = mesh.rank == 0
    out = {"serial": {}, "cases": {}}
    if rank0:
        for kind, layers, _, _, masked, _ in CASES:
            out["serial"][kind, layers, masked] = _serial(kind, layers,
                                                          masked)
    for case in CASES:
        res = _case(mesh, *case)
        kind, layers, _, _, masked, _ = case
        if rank0:
            res["rel_params"] = _rel_l2(
                res["params"], out["serial"][kind, layers, masked][2])
        res["params"] = sum(float(p.double().sum())
                            for p in res["params"].values())
        out["cases"][case] = res
    out["train"] = train.main(TRAIN_ARGS + ["--strategy", "pipeline"])
    model = _model("qwen", 4)
    ctx22 = ShardingCtx("cpu", mesh=mesh22)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["validate"] = validate(
            model, model.cfg, _batch(), ctx22, ["pipeline"],
            flops_per_sample=1e6, B=B, S=SEQ,
            cluster=ClusterSpec.of("host"))
    out["bubble"] = measure_schedule_bubble(
        model, lambda n: {"tokens": _batch()["tokens"][:n]}, ctx22,
        schedule="one_f_one_b", S_small=4, S_large=8, microbatch=1)
    out["serial"] = {k: v[:2] for k, v in out["serial"].items()}
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_ranks, 4, backend="gloo", device="cpu", model=2,
                     timeout_s=300)


def test_stage_helpers_match_the_reference():
    """The layers each rank runs are the valid slots of the reference's
    padded layouts, plain and interleaved, for uneven cuts;
    block_costs_from_stats equals the reference's on each model's stats;
    an LM's blocks are its layers, named and costed so."""
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.core.layer_stats import stats_for as j_stats_for
    from repro.parallel.schedules import stages as jstages
    for L, bounds in ((10, (0, 2, 5, 6, 10)), (7, (0, 1, 4, 5, 7))):
        idx, mask = jstages.stack_stage_bounds(jnp.arange(L), bounds)
        want = [tuple(int(j) for j in row[m]) for row, m in
                zip(np.asarray(idx), np.asarray(mask))]
        assert stack_stage_bounds(bounds) == want
    bounds = (0, 1, 3, 4, 6, 7, 8, 9, 10)
    idx, mask = jstages.stack_virtual_stage_bounds(jnp.arange(10), bounds,
                                                   4, 2)
    want = [[tuple(int(j) for j in row[m]) for row, m in zip(ir, im)]
            for ir, im in zip(np.asarray(idx), np.asarray(mask))]
    assert stack_virtual_stage_bounds(bounds, 4, 2) == want
    with pytest.raises(ValueError, match="empty stage"):
        stack_stage_bounds((0, 2, 2, 4))
    for port, ref in (
            (get_config("qwen1.5-4b").model, j_get_config("qwen1.5-4b").model),
            (get_config("mamba2-780m").model,
             j_get_config("mamba2-780m").model),
            (_cfg("mixed", 5), _cfg("mixed", 5, j_get_config, _jax_fp32))):
        L = port.n_layers
        got = block_costs_from_stats(stats_for(port, 512), L)
        np.testing.assert_allclose(
            got, jstages.block_costs_from_stats(j_stats_for(ref, 512), L),
            rtol=1e-12)
        assert len(set(got)) == len(set(port.pattern))
    lm = _model("mixed", 5)
    blocks = model_pipe_blocks(lm, stats_for(lm.cfg, SEQ))
    assert [b.name for b in blocks] == ["L0.ssm", "L1.attn", "L2.ssm",
                                        "L3.attn", "L4.ssm"]
    assert all(all(k.startswith(f"blocks.{j}.") for k in b.params)
               and b.params for j, b in enumerate(blocks))
    np.testing.assert_array_equal(
        [b.cost for b in blocks],
        block_costs_from_stats(stats_for(lm.cfg, SEQ), 5))


def test_bridge_carries_the_tail_of_a_mixed_lm():
    """The reference's ("ssm", "attn") 5-layer LM keeps layer 4 in ``tail``:
    the bridge places it at blocks.4, and the port's forward and loss match
    the reference's (a leaf left out or doubled raises)."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models.transformer import TransformerLM as JLM
    from repro.nn.module import NULL_CTX, tree_init
    jcfg = _cfg("mixed", 5, j_get_config, _jax_fp32)
    jm = JLM(jcfg)
    params = jax.jit(lambda k: tree_init(jm.params_spec(), k))(
        jax.random.PRNGKey(0))
    tokens = _tokens()
    logits_j, _ = jm.apply(params, tokens, NULL_CTX, q_chunk=CHUNK,
                           kv_chunk=CHUNK)
    loss_j, _ = jm.loss_fn(params, {"tokens": tokens}, NULL_CTX,
                           q_chunk=CHUNK, kv_chunk=CHUNK)
    tree = jax.tree.map(np.asarray, params)
    assert sorted(tree["tail"][0]) == sorted(tree["stacks"][0])
    model = _model("mixed", 5)
    load_jax_params(model, tree)
    batch = _batch()
    with torch.no_grad():
        logits, _ = model(batch["tokens"], CPU, q_chunk=CHUNK, kv_chunk=CHUNK)
        loss, _ = model.loss_fn(batch, CPU, q_chunk=CHUNK, kv_chunk=CHUNK)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-4)
    assert abs(float(loss) - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    tail_only = dict(tree, tail=[])
    with pytest.raises(ValueError, match=r"missing \['blocks\.4\."):
        load_jax_params(model, tail_only)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_lm_pipeline_step_matches_the_serial_step(ranks, case):
    """Loss, clipping norm and updated parameters against the serial step;
    every rank holds the same model after the gather, and a tied table is
    updated alike on the first and the last stage."""
    kind, layers, _, v, masked, _ = case
    loss, norm = ranks[0]["serial"][kind, layers, masked]
    for r in ranks:
        got = r["cases"][case]
        assert got["S"] == SEG
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (case, got, loss)
        assert abs(got["grad_norm"] - norm) <= 1e-5 * norm, (case, got, norm)
        assert got["params"] == ranks[0]["cases"][case]["params"]
        assert got["bounds"] == ranks[0]["cases"][case]["bounds"]
    got = ranks[0]["cases"][case]
    assert got["rel_params"] <= 1e-4, (case, got["rel_params"])
    assert len(got["bounds"]) == 4 * v + 1
    if kind == "mamba":
        assert got["shared"] == {"embed.table": 3}
        assert torch.equal(ranks[3]["cases"][case]["table"], got["table"])
    else:
        assert got["shared"] == {}
    costs = block_costs_from_stats(stats_for(_cfg(kind, layers), SEQ),
                                   layers) if case[-1] else np.ones(layers)
    assert got["bounds"] == min_max_partition(costs, 4 * v).bounds


def test_trainer_validate_and_bubble_take_an_lm(ranks):
    """The trainer pipelines the bf16 smoke Mamba across the ranks (first
    loss as the single-process trainer's); validate measures and projects
    the Qwen's pipeline row at p = 4, at S = clip_segments(8, 8) = 8;
    the bubble fit and the schedule winner take an LM."""
    single = train.main(TRAIN_ARGS)["losses"][0]
    for r in ranks:
        (first,) = r["train"]["losses"]
        assert abs(first - single) <= 1e-5 * abs(single), (first, single)
    (pt,) = ranks[0]["validate"]
    assert pt.strategy == "pipeline" and pt.p == 4
    assert math.isfinite(pt.measured_s) and pt.measured_s > 0
    cfg = _cfg("qwen", 4)
    cluster = ClusterSpec.of("host")
    stats = stats_for(cfg, SEQ)
    oc = OracleConfig(B=B, D=B, segments=8, **cluster.oracle_kw())
    assert pt.projected_s == project("pipeline", stats,
                                     TimeModel(cluster.system), oc, 4).total_s
    b = ranks[0]["bubble"]
    assert (b["S_small"], b["S_large"]) == (4, 8)
    assert all(math.isfinite(b[k]) and b[k] >= 0
               for k in ("t_small_s", "t_large_s", "bubble_fraction"))
    assert schedule_winner(stats, TimeModel(cluster.system), oc, 4) in (
        "gpipe", "one_f_one_b", "interleaved")


# ---------------------------------------------------------------------------
# The witness: the reference's pipeline step in a subprocess
# ---------------------------------------------------------------------------

def _jax_fp32(cfg, **kw):
    import jax.numpy as jnp
    cfg = dataclasses.replace(cfg, **kw)
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=jnp.float32)
           for k in ("attn", "ffn", "ssm") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=jnp.float32, **sub)


def _check(out_path):
    import jax
    from repro.configs import get_config as j_get_config
    from repro.launch.compat import make_mesh
    from repro.models.transformer import TransformerLM as JLM
    from repro.nn.module import ShardingCtx as JCtx
    from repro.nn.module import tree_init
    from repro.optim.optimizers import OptimizerConfig as JOpt
    from repro.parallel import make_pipeline_train_step, make_rules
    from repro.training.steps import train_state_spec
    assert len(jax.devices()) == 4, jax.devices()
    ctx = JCtx(make_mesh((1, 4), ("data", "model")), make_rules("pipeline"))
    opt = JOpt(name="sgd", lr=LR, zero1=False, grad_clip=1e9)
    out = {}
    for kind, layers, schedule in WITNESS:
        model = JLM(_cfg(kind, layers, j_get_config, _jax_fp32))
        state = tree_init(train_state_spec(model, opt), jax.random.PRNGKey(0))
        step = jax.jit(make_pipeline_train_step(
            model, opt, ctx, segments=SEG, schedule=schedule, q_chunk=CHUNK,
            kv_chunk=CHUNK))
        new, metrics = step(state, {"tokens": jax.numpy.asarray(_tokens())})
        tag = f"{kind}{layers}"
        for what, tree in (("init", state["params"]), ("new", new["params"])):
            for k, a in flatten(jax.tree.map(np.asarray, tree)).items():
                out[f"{tag}/{what}/{k}"] = a
        out[f"{tag}/loss"] = np.float64(metrics["loss"])
        out[f"{tag}/S"] = np.int64(metrics["pipeline_segments"])
        print(f"{tag} {schedule}: loss {float(metrics['loss'])!r}")
    np.savez(out_path, **out)
    print("WITNESS-WRITTEN")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_pipeline_witness") / "ref.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    run = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "WITNESS-WRITTEN" in run.stdout, run.stdout + run.stderr[-3000:]
    return dict(np.load(out))


def _flat(ref, prefix):
    """The reference's leaves under ``prefix``, dotted as ``flatten``
    names them (stacked, and the tail apart)."""
    return {k[len(prefix):]: a for k, a in ref.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("kind,layers,schedule", WITNESS)
def test_reference_lm_pipeline_step_equals_the_ports_serial_step(
        reference, kind, layers, schedule):
    tag = f"{kind}{layers}"
    assert int(reference[f"{tag}/S"]) == SEG
    loss, _, params = _serial(kind, layers, False,
                              _flat(reference, f"{tag}/init/"))
    ref_loss = float(reference[f"{tag}/loss"])
    assert abs(ref_loss - loss) <= 1e-5 * abs(loss), (tag, ref_loss, loss)
    new = {k: torch.from_numpy(a) for k, a in
           _unstack_layers(_flat(reference, f"{tag}/new/")).items()}
    assert set(new) == set(params)
    assert _rel_l2(new, params) <= 1e-4, (tag, _rel_l2(new, params))


if __name__ == "__main__":
    _check(sys.argv[1])
