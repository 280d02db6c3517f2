"""The sharded serving layouts on 4 gloo ranks on the CPU, a (1, 4) mesh:
the smoke Qwen1.5-4B (2 layers, d 64, 4 heads of 16, vocab 512) in fp32
with JAX's ``tree_init`` weights behind the continuous-batching engine,
under serve_tp (weights and the cache's kv heads split, one head a rank;
``kv_shards`` 1) and serve_seqkv (weights split, the cache's span split
into 4 shards, merged across ranks as flash decoding does; ``kv_shards``
4). The trace: TrafficModel(rate 50, prompt 16, gen 8, spread 0), 6
requests, seed 0; max_len 64, 4 decode slots, 16-token blocks and
16-token prefill chunks.

One spawn of 4 ranks serves the whole file. Rank 0 first runs the port's
single-process engine on its one thread (a reference at another thread
count rounds its sums differently). Each rank then replays the trace
closed-loop under each layout; its tokens must equal the single-process
engine's for every request, and the first prompt chunk's logits (its
decode_step on a fresh sharded dense cache, gathered whole) must lie
within 1e-5 of the single-process ones in relative L2, as must those of
request 0's whole prompt pass (``prefill``) and of a decode step after
it. An open-loop
replay (the ranks admit against rank 0's clock) must give every rank the
same admissions step by step, and the same tokens. ``measure_serving``
runs both layouts; ``launch.serve.main`` serves serve_seqkv under the
spawned world with its default ``--kv-shards`` (4); on a (2, 2) regrid
the engine and ``measure_serving`` take a decode batch split over the data
axis and refuse one that does not split
(``tests/test_torch_serve_auto.py`` serves on that mesh).
Every cell call runs the norm through the kernel's wrapper (its plain
version on the CPU) 2·L + 1 times a rank, and each rank's pool is its
block of the reference's pool as the JAX rules place it.

The witness: the JAX package's own ``measure_serving`` under both tables
on a (1, 4) mesh of 4 virtual host devices, in a subprocess (``python
<this file> <out.npz>``), on the same weights and trace. Its tokens must
equal the port's. No test here reads a time.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.core.validation import measure_serving
from repro_torch.launch import serve
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.transformer import TransformerLM, greedy
from repro_torch.nn import layers
from repro_torch.nn.module import ShardingCtx, zeros_like_spec
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharded import shard_params
from repro_torch.parallel.strategies import make_rules
from repro_torch.serve import Engine, ServeConfig, TrafficModel

ARCH = "qwen1.5-4b"
LAYOUTS = (("serve_tp", 1), ("serve_seqkv", 4))
TRAFFIC = dict(rate=50.0, prompt_len=16, gen_len=8, spread=0.0)
N_REQ, CHUNK = 6, 16
SCFG = dict(max_len=64, max_batch=4, block_tokens=16, prefill_chunk=CHUNK)
F32 = torch.float32
CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--closed-loop",
       "--requests", "4", "--strategy", "serve_seqkv"]


def _fp32(cfg, dt):
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=dt)
           for k in ("attn", "ffn") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=dt, **sub)


def _trace(vocab):
    return TrafficModel(**TRAFFIC).trace(N_REQ, vocab, seed=0)


def _model(params, ctx=None):
    model = TransformerLM(_fp32(get_config(ARCH).smoke_model, F32),
                          device=torch.device("cpu"), generator=None)
    if ctx is not None:
        shard_params(model, ctx)
    load_jax_params(model, params)
    return model


def _prompt_then_decode(model, ctx, trace, shards):
    """The logits of request 0's prompt pass (its last position) and of
    one greedy decode step after it, on a fresh dense cache, whole."""
    cache = zeros_like_spec(model.cache_spec(1, SCFG["max_len"],
                                             shards=shards, dtype=F32),
                            "cpu", ctx)
    prompt = torch.from_numpy(trace[0].prompt[None])
    with torch.no_grad():
        first, cache = model.prefill(prompt, cache, ctx, q_chunk=8,
                                     kv_chunk=8)
        second, _ = model.decode_step(greedy(first), cache,
                                      prompt.shape[1], ctx)
    return [t.full() if ctx.sharded else t for t in (first, second)]


def _first_chunk(model, ctx, trace, shards):
    """The logits (1, CHUNK, vocab) of request 0's first prompt chunk on a
    fresh dense cache, whole."""
    cache = zeros_like_spec(model.cache_spec(1, SCFG["max_len"],
                                             shards=shards, dtype=F32),
                            "cpu", ctx)
    with torch.no_grad():
        lg, _ = model.decode_step(torch.from_numpy(trace[0].prompt[None,
                                                                   :CHUNK]),
                                  cache, torch.tensor([0]), ctx)
    return lg.full() if ctx.sharded else lg


# calls of the norm kernel's wrapper on this rank (``_ranks`` counts them)
NORMS = [0]


class _Cells:
    """Per ``decode_step`` call of a model: its chunk length, the norm's
    calls through the kernel's wrapper and the collectives."""

    def __init__(self, model):
        self.calls = []
        self.model, self.step = model, model.decode_step
        model.decode_step = self

    def __call__(self, tokens, *args):
        n0, c0 = NORMS[0], coll.STATS["calls"]
        out = self.step(tokens, *args)
        self.calls.append((tokens.shape[1], NORMS[0] - n0,
                           coll.STATS["calls"] - c0))
        return out

    def done(self):
        del self.model.decode_step
        return self.calls


def _ranks(mesh, params, json_out):
    vocab = _fp32(get_config(ARCH).smoke_model, F32).vocab
    trace = _trace(vocab)
    out, every = {}, {}
    if mesh.rank == 0:
        one = ShardingCtx("cpu", use_pallas=True)
        model = _model(params)
        rep = Engine(model, one, ServeConfig(dtype=F32, **SCFG)).run(
            trace, honor_arrivals=False)
        out["single"] = ([r.tokens for r in rep.requests],
                         _first_chunk(model, one, trace, 1),
                         _prompt_then_decode(model, one, trace, 1))
    norm = layers.rmsnorm

    def counted(*a, **k):
        NORMS[0] += 1
        return norm(*a, **k)

    layers.rmsnorm = counted
    try:
        for s, shards in LAYOUTS:
            ctx = ShardingCtx("cpu", use_pallas=True, mesh=mesh,
                              rules=make_rules(s))
            model = _model(params, ctx)
            scfg = ServeConfig(kv_shards=shards, dtype=F32, **SCFG)
            out[s, "logits"] = _first_chunk(model, ctx, trace, shards)
            out[s, "prefill"] = _prompt_then_decode(model, ctx, trace,
                                                    shards)
            cells = _Cells(model)
            eng = Engine(model, ctx, scfg)
            rep = eng.run(trace, honor_arrivals=False)
            every[s, "cells"] = cells.done()
            every[s, "tokens"] = [r.tokens for r in rep.requests]
            every[s, "pool"] = {n: (tuple(t.local.shape), t.place)
                                for n, t in eng.pool["blocks"][0].items()}
            # serve_tp from the whole model (measure_serving cuts its
            # blocks), serve_seqkv from this rank's blocks
            every[s, "measured"] = [r.tokens for r in measure_serving(
                _model(params) if s == "serve_tp" else model, ctx, s, scfg,
                trace).requests]
            if s == "serve_seqkv":
                eng = Engine(model, ctx, scfg)
                steps, step = [], eng.step

                def recorded():
                    n = step()
                    steps.append(tuple(q.req.rid if q else -1
                                       for q in eng.slots))
                    return n

                eng.step = recorded
                rep = eng.run(trace, honor_arrivals=True)
                every["open"] = (steps, [r.tokens for r in rep.requests])
    finally:
        layers.rmsnorm = norm
    out["cli"] = serve.main(CLI + ["--json-out", json_out])
    mesh22 = mesh.regrid(2, 2)
    ctx22 = ShardingCtx("cpu", mesh=mesh22, rules=make_rules("serve_tp"))
    odd = dict(SCFG, max_batch=3)
    Engine(model, ctx22, ServeConfig(**SCFG))       # a batch of 4 splits
    for name, call in (
            ("engine", lambda cfg: Engine(model, ctx22, ServeConfig(**cfg))),
            ("measure_serving", lambda cfg: measure_serving(
                model, ctx22, "serve_seqkv",
                ServeConfig(kv_shards=2, **cfg), trace))):
        try:
            call(odd)
            every["mesh22", name] = None
        except ValueError as e:
            every["mesh22", name] = str(e)
    return (out if mesh.rank == 0 else None), every


def _jax_params():
    """JAX's fp32 smoke weights as numpy (jax is imported here: the ranks
    import this module)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import TransformerLM as JLM
    from repro.nn.module import tree_init
    jlm = JLM(_fp32(j_get_config(ARCH).smoke_model, jnp.float32))
    params = tree_init(jlm.params_spec(), jax.random.PRNGKey(0))
    return jlm, params


def _witness(out_path):
    """The reference's measure_serving under both tables on (1, 4)."""
    import jax
    import jax.numpy as jnp
    from repro.core.validation import measure_serving as j_measure_serving
    from repro.launch.compat import make_mesh
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import TrafficModel as JTrafficModel
    assert len(jax.devices()) == 4, jax.devices()
    jlm, params = _jax_params()
    trace = JTrafficModel(**TRAFFIC).trace(N_REQ, jlm.cfg.vocab, seed=0)
    mesh = make_mesh((1, 4), ("data", "model"))
    out = {f"prompt/{r.rid}": np.asarray(r.prompt) for r in trace}
    for s, shards in LAYOUTS:
        rep = j_measure_serving(jlm, mesh, s, JServeConfig(
            kv_shards=shards, dtype=jnp.float32, **SCFG), trace,
            params=params)
        for r in rep.requests:
            out[f"{s}/{r.rid}"] = np.asarray(r.tokens, np.int64)
        print(f"{s}: {[list(map(int, r.tokens)) for r in rep.requests]}")
    np.savez(out_path, **out)
    print("WITNESS-WRITTEN")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro_torch.bridge import flatten
    tmp = tmp_path_factory.mktemp("serve_parallel")
    _, params = _jax_params()
    params = flatten(jax.tree.map(np.asarray, params))
    res = run_ranks(_ranks, 4, params, str(tmp / "serve.json"),
                    backend="gloo", device="cpu", model=4, timeout_s=240)
    got = res[0][0]
    for key in res[0][1]:
        got[key] = [every[key] for _, every in res]        # every rank's
    got["json"] = json.loads((tmp / "serve.json").read_text())
    return got


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_witness") / "ref.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    run = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "WITNESS-WRITTEN" in run.stdout, run.stdout + run.stderr[-3000:]
    return dict(np.load(out))


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("layout", [s for s, _ in LAYOUTS])
def test_sharded_engine_matches_the_single_process_engine(runs, layout):
    """Every rank gives every request the single-process engine's tokens;
    the first prompt chunk's logits within 1e-5 in relative L2."""
    single, logits, _ = runs["single"]
    assert len(single) == N_REQ and all(len(t) == 8 for t in single)
    for rank, tokens in enumerate(runs[layout, "tokens"]):
        assert tokens == single, (layout, rank)
    got = runs[layout, "logits"]
    assert got.shape == logits.shape == (1, CHUNK, 512)
    assert _rel_l2(got, logits) <= 1e-5, _rel_l2(got, logits)


@pytest.mark.parametrize("layout", [s for s, _ in LAYOUTS])
def test_sharded_prompt_pass_then_decode(runs, layout):
    """TransformerLM.prefill across ranks (the prompt's keys and values
    written into each rank's heads or positions) and one decode step after
    it: the logits within 1e-5 of the single-process ones in relative
    L2."""
    want = runs["single"][2]
    for got, ref in zip(runs[layout, "prefill"], want, strict=True):
        assert got.shape == ref.shape == (1, 1, 512)
        assert _rel_l2(got, ref) <= 1e-5, _rel_l2(got, ref)


@pytest.mark.parametrize("layout", [s for s, _ in LAYOUTS])
def test_reference_witness_gives_the_ports_tokens(runs, witness, layout):
    """The JAX package's measure_serving on (1, 4) under the same table,
    weights and trace: the same tokens for every request."""
    trace = _trace(512)
    for r in trace:
        np.testing.assert_array_equal(witness[f"prompt/{r.rid}"], r.prompt)
    want = [list(map(int, witness[f"{layout}/{r.rid}"])) for r in trace]
    assert runs[layout, "tokens"][0] == want
    assert runs["single"][0] == want


def test_open_loop_admissions_agree(runs):
    """An open-loop replay (honor_arrivals) under serve_seqkv: every rank
    admits the same requests into the same slots at every step (rank 0's
    clock), so the collectives meet; the tokens are the closed loop's."""
    steps = [s for s, _ in runs["open"]]
    assert steps[0] and all(s == steps[0] for s in steps)
    for _, tokens in runs["open"]:
        assert tokens == runs["single"][0]


def test_measure_serving_runs_both_layouts(runs):
    """measure_serving (a warm-up replay, reset, the measured one) under
    each layout at width 4, kv_shards 1 and 4, given the whole model
    (serve_tp) or this rank's blocks (serve_seqkv): the single-process
    tokens on every rank."""
    for s, _ in LAYOUTS:
        for tokens in runs[s, "measured"]:
            assert tokens == runs["single"][0], s


def test_serve_cli_under_a_spawned_world(runs):
    """launch.serve.main in the spawned world with --strategy serve_seqkv:
    the default --kv-shards is the mesh's model size, every request
    served, rank 0 writes the report."""
    assert runs["cli"]["requests"] == 4 and runs["cli"]["tokens"] == 4 * 16
    written = runs["json"]
    assert written["strategy"] == "serve_seqkv"
    assert written["mesh"] == {"data": 1, "model": 4}
    assert written["config"]["kv_shards"] == 4
    assert written["config"]["max_len"] % (16 * 4) == 0


def test_a_data_axis_raises_naming_item_7(runs):
    """A data axis serves now (queue 1 item 7 is done): on the (2, 2)
    regrid the engine takes a batch of 4, and a batch of 3, which the data
    axis cannot split, raises on every rank, for the engine and for
    measure_serving."""
    for name in ("engine", "measure_serving"):
        for msg in runs["mesh22", name]:
            assert msg is not None and "max_batch=3" in msg, (name, msg)


def test_every_cell_takes_the_norm_kernels_path(runs):
    """Each cell call (a prefill chunk or a decode batch) runs the norm
    through the rmsnorm kernel's wrapper 2·L + 1 times on every rank, as
    the single-device engine does (its launches on the card)."""
    n_layers = get_config(ARCH).smoke_model.n_layers
    for s, _ in LAYOUTS:
        for rank, cells in enumerate(runs[s, "cells"]):
            assert {c for c, _, _ in cells} == {1, CHUNK}, (s, rank)
            assert {n for _, n, _ in cells} == {2 * n_layers + 1}, (s, rank)


def test_collectives_a_cell(runs):
    """The collectives of a decode_step call at C = 1 (a decode batch) and
    at a prefill chunk, the same on every rank (the engine's greedy token
    adds one gather a cell). serve_tp: the embedding's all-reduce and two
    row-parallel all-reduces a layer; a chunk, whose sequence splits over
    the ranks, gathers it before each projection and the logits' vocab
    before their split on the sequence. serve_seqkv: the same plus q, k
    and v gathered whole (3 a layer) and the merge (the max, then the
    partial sums: 2 a layer)."""
    L = get_config(ARCH).smoke_model.n_layers
    want = {"serve_tp": {1: 2 * L + 1, CHUNK: 4 * L + 3},
            "serve_seqkv": {1: 7 * L + 1, CHUNK: 9 * L + 3}}
    for s, _ in LAYOUTS:
        per = [{c: n for c, _, n in cells} for cells in runs[s, "cells"]]
        assert all(p == per[0] for p in per), s
        assert per[0] == want[s], (s, per[0])


def test_each_ranks_pool_is_its_block_of_the_references(runs):
    """The local pool leaves have the shapes and splits the JAX rules give
    the reference's pool on (1, 4): serve_tp its kv heads, serve_seqkv its
    shards of every block."""
    import types
    from repro.nn.module import spec_to_pspec
    from repro.parallel.strategies import make_rules as j_make_rules
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 4})
    for s, shards in LAYOUTS:
        blocks = SCFG["max_len"] // SCFG["block_tokens"] * SCFG[
            "max_batch"] + 1
        shape = (blocks, shards, SCFG["block_tokens"] // shards, 4, 16)
        pspec = spec_to_pspec((None, "seq", None, "act_kv", None),
                              j_make_rules(s), mesh, shape)
        want = tuple(n // (4 if p else 1) for n, p in zip(shape, pspec))
        assert math.prod(shape) // math.prod(want) == 4, (s, pspec)
        for pool in runs[s, "pool"]:
            for name, (local, _) in pool.items():
                assert local == want, (s, name, local, want)


if __name__ == "__main__":
    _witness(sys.argv[1])
