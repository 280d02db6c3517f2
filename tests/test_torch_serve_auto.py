"""Serving on a (p1, p2) mesh with p1 > 1, and ``launch/serve.py
--strategy auto``, on 4 gloo ranks on the CPU.

The smoke Qwen1.5-4B (2 layers, d 64, 4 heads of 16, vocab 512) in fp32
with JAX's ``tree_init`` weights behind the continuous-batching engine on a
(2, 2) mesh: the decode batch's 4 rows split in blocks over "data", each
data group running serve_tp (the cache's kv heads split over its 2 "model"
ranks; ``kv_shards`` 1) or serve_seqkv (the cache's span split into 2
shards; ``kv_shards`` 2); a prompt chunk (one row) computed by both
groups. The trace: TrafficModel(rate 50, prompt 16, gen 8, spread 0), 6
requests, seed 0; max_len 64, 16-token blocks and prefill chunks. Every
rank's tokens must equal the port's single-process engine's
(``tests/test_torch_serve_engine.py`` holds that engine to the
reference's), every cell call must run the norm through the kernel's
wrapper 2·L + 1 times on every rank, and a ``max_batch`` that the data
axis cannot split raises.

``launch.serve.main --strategy auto`` in the same spawned world, in two
cases: the default ``host`` machine, where the tuner picks data on
(4, 1), and a ``--cluster`` JSON of the host with a 1 MB memory capacity,
where it picks a plan of model width 2 on (2, 2). Rank 0's printed plan
and the deployed layout and mesh must be the reference's
``resolve_auto_strategy``'s for the same arguments, and every rank must
hold the same tokens. One spawn of 4 ranks serves the whole file; no test
reads a time.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import layers
from repro_torch.nn.module import ShardingCtx
from repro_torch.parallel.sharded import shard_params
from repro_torch.parallel.strategies import make_rules
from repro_torch.serve import Engine, ServeConfig, TrafficModel

# One torch thread a test process. The suite runs 6 xdist workers on 8
# cores, and every worker imports this file when it collects: at torch's
# default of a thread per core the workers stall each other and the JAX
# package's multi-device subprocesses (a spawned rank sets the same,
# launch/spawn.py).
torch.set_num_threads(1)

ARCH = "qwen1.5-4b"
LAYOUTS = (("serve_tp", 1), ("serve_seqkv", 2))
TRAFFIC = dict(rate=50.0, prompt_len=16, gen_len=8, spread=0.0)
N_REQ = 6
SCFG = dict(max_len=64, max_batch=4, block_tokens=16, prefill_chunk=16)
F32 = torch.float32
CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--closed-loop",
       "--requests", "4", "--prompt-len", "16", "--gen", "8",
       "--max-batch", "4", "--strategy", "auto"]


def _fp32(cfg):
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=F32)
           for k in ("attn", "ffn") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=F32, **sub)


def _model(params, ctx=None):
    model = TransformerLM(_fp32(get_config(ARCH).smoke_model),
                          device=torch.device("cpu"), generator=None)
    if ctx is not None:
        shard_params(model, ctx)
    load_jax_params(model, params)
    return model


def _ranks(mesh, params, cases):
    """One rank: the single-process engine's tokens (rank 0), each
    layout's tokens and norm calls a cell call on the (2, 2) mesh, the
    refusal of an odd ``max_batch``, and the CLI under auto per case."""
    trace = TrafficModel(**TRAFFIC).trace(N_REQ, _fp32(
        get_config(ARCH).smoke_model).vocab, seed=0)
    out = {}
    if mesh.rank == 0:
        one = ShardingCtx("cpu", use_pallas=True)
        rep = Engine(_model(params), one, ServeConfig(dtype=F32, **SCFG)
                     ).run(trace, honor_arrivals=False)
        out["single"] = [r.tokens for r in rep.requests]
    norm, calls = layers.rmsnorm, [0]

    def counted(*a, **k):
        calls[0] += 1
        return norm(*a, **k)

    layers.rmsnorm = counted
    try:
        for s, shards in LAYOUTS:
            ctx = ShardingCtx("cpu", use_pallas=True, mesh=mesh,
                              rules=make_rules(s))
            model = _model(params, ctx)
            per_cell, step = [], model.decode_step

            def cell(*a, step=step, per_cell=per_cell):
                n0 = calls[0]
                y = step(*a)
                per_cell.append(calls[0] - n0)
                return y

            model.decode_step = cell
            eng = Engine(model, ctx, ServeConfig(kv_shards=shards, dtype=F32,
                                                 **SCFG))
            rep = eng.run(trace, honor_arrivals=False)
            out[s] = {"tokens": [r.tokens for r in rep.requests],
                      "norms": sorted(set(per_cell)),
                      "pool": tuple(eng.pool["blocks"][0]["k"].local.shape)}
    finally:
        layers.rmsnorm = norm
    try:
        Engine(model, ctx, ServeConfig(dtype=F32, **dict(SCFG, max_batch=3)))
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    for name, extra in cases:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            got = serve.main(CLI + extra)
        out["cli", name] = (got["strategy"], got["mesh"],
                            got["tokens_by_request"],
                            text.getvalue() if mesh.rank == 0 else None)
    return out


def _cases(tmp):
    """The CLI's cluster arguments: the default host, and the host with a
    1 MB memory capacity in a --cluster JSON."""
    from repro_torch.core.cluster import ClusterSpec
    path = tmp / "tight.json"
    path.write_text(json.dumps(dataclasses.replace(
        ClusterSpec.of("host"), mem_capacity=1e6).to_json()))
    return (("host", []), ("tight", ["--cluster", str(path)]))


def _reference_plan(extra):
    """The reference's ``resolve_auto_strategy`` on 4 devices for the CLI's
    arguments: ((strategy, width), the printed plan)."""
    import argparse
    from repro.configs import get_config as j_get_config
    from repro.core.cluster import add_cluster_args
    from repro.launch.serve import resolve_auto_strategy
    ap = argparse.ArgumentParser()
    add_cluster_args(ap, default_system="host")
    for flag in ("--max-batch", "--prompt-len", "--gen"):
        ap.add_argument(flag, type=int)
    args, _ = ap.parse_known_args(CLI + extra)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        got = resolve_auto_strategy(j_get_config(ARCH).smoke_model, args, 4)
    return got, text.getvalue().strip()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import TransformerLM as JLM
    from repro.nn.module import tree_init
    from repro_torch.bridge import flatten
    import jax.numpy as jnp
    tmp = tmp_path_factory.mktemp("serve_auto")
    cfg = j_get_config(ARCH).smoke_model
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=jnp.float32)
           for k in ("attn", "ffn") if getattr(cfg, k) is not None}
    jlm = JLM(dataclasses.replace(cfg, dtype=jnp.float32, **sub))
    params = flatten(jax.tree.map(np.asarray, tree_init(
        jlm.params_spec(), jax.random.PRNGKey(0))))
    cases = _cases(tmp)
    res = run_ranks(_ranks, 4, params, cases, backend="gloo", device="cpu",
                    model=2, timeout_s=180)
    return res, {name: _reference_plan(extra) for name, extra in cases}


@pytest.mark.parametrize("layout", [s for s, _ in LAYOUTS])
def test_every_rank_gives_the_single_process_tokens(runs, layout):
    res, _ = runs
    want = res[0]["single"]
    assert len(want) == N_REQ and all(len(t) == 8 for t in want)
    for rank, out in enumerate(res):
        assert out[layout]["tokens"] == want, (layout, rank)


@pytest.mark.parametrize("layout", [s for s, _ in LAYOUTS])
def test_each_cell_runs_the_norm_kernels_path_on_every_rank(runs, layout):
    res, _ = runs
    n_layers = get_config(ARCH).smoke_model.n_layers
    for out in res:
        assert out[layout]["norms"] == [2 * n_layers + 1], layout


def test_every_data_group_holds_the_whole_pool(runs):
    """The blocks axis is replicated over "data": each rank's pool leaf
    has every block; serve_tp splits its kv heads over the 2 model ranks,
    serve_seqkv its 2 shards."""
    res, _ = runs
    hd = get_config(ARCH).smoke_model.attn.head_dim
    heads = get_config(ARCH).smoke_model.attn.n_kv_heads
    for out in res:
        tp, seq = out["serve_tp"]["pool"], out["serve_seqkv"]["pool"]
        assert tp[0] == seq[0] == 4 * 4 + 1            # max_batch·n_blk + 1
        assert tp[1:] == (1, 16, heads // 2, hd)
        assert seq[1:] == (1, 8, heads, hd)


def test_a_batch_the_data_axis_cannot_split_raises(runs):
    res, _ = runs
    for out in res:
        assert out["odd"] is not None and "max_batch=3" in out["odd"]


@pytest.mark.parametrize("case", ["host", "tight"])
def test_auto_deploys_the_references_plan(runs, case):
    res, ref = runs
    (strategy, width), printed = ref[case]
    shapes = set()
    for out in res:
        got_strategy, mesh, _, _ = out["cli", case]
        assert got_strategy == strategy
        assert mesh == {"data": 4 // width, "model": width}
        shapes.add(tuple(mesh.values()))
    assert res[0]["cli", case][3].splitlines()[0] == printed
    assert shapes == ({(4, 1)} if case == "host" else {(2, 2)})


@pytest.mark.parametrize("case", ["host", "tight"])
def test_auto_tokens_reach_every_rank(runs, case):
    res, _ = runs
    tokens = [out["cli", case][2] for out in res]
    assert len(tokens[0]) == 4 and all(len(t) == 8 for t in tokens[0])
    assert all(t == tokens[0] for t in tokens)
