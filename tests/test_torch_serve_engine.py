"""The port's continuous-batching engine (serve/engine.py) on the CPU, on the
tiny fp32 MHA LM of tests/test_torch_kv_cache.py (the JAX ``tree_init``
parameters carried over by repro_torch.bridge): admission control as
tests/test_serve.py pins it; continuous batching against a solo dense-cache
greedy decode; the port's engine against the JAX package's engine on the
same parameters and requests (each request's tokens equal: fp32, and the
logits of the two packages agree to ~1e-6, far from any tie here); every
cache position the engine writes inside [0, max_len); ``measure_serving``
and the serving CLI; and what the port refuses."""
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.module import NULL_CTX
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeReport as JServeReport
from repro_torch.core.validation import measure_serving
from repro_torch.launch import serve
from repro_torch.nn.module import ShardingCtx, zeros_like_spec
from repro_torch.serve import (Engine, Request, ServeConfig, ServeReport,
                               TrafficModel)
from test_torch_kv_cache import V, mk_lms

CPU = ShardingCtx("cpu")
F32 = torch.float32


@pytest.fixture(scope="module")
def lms():
    return mk_lms()


def _requests(lens, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, V, size=L, dtype=np.int32),
                    max_new=max_new) for i, L in enumerate(lens)]


@torch.no_grad()
def solo_greedy(lm, prompt, max_new, max_len):
    """Dense-cache single-sequence greedy decode (the engine's reference)."""
    cache = zeros_like_spec(lm.cache_spec(1, max_len, dtype=F32), "cpu")
    lg, cache = lm.prefill(torch.from_numpy(prompt[None]), cache, CPU)
    toks = [int(lg[0, 0].argmax())]
    for i in range(max_new - 1):
        lg, cache = lm.decode_step(torch.tensor([[toks[-1]]]), cache,
                                   len(prompt) + i, CPU)
        toks.append(int(lg[0, 0].argmax()))
    return toks


def test_engine_admission_control(lms):
    lm = lms[2]
    cfg = ServeConfig(max_len=32, max_batch=3, block_tokens=8,
                      prefill_chunk=8, num_blocks=9, dtype=F32)
    eng = Engine(lm, CPU, cfg)
    with pytest.raises(ValueError):          # can never fit: 40+8 > 32 slots
        eng.submit(Request(0, np.ones(33, np.int32), 8))
    # r0 (2 blocks) + r1 (4 blocks) leave 2 of the pool's 8 blocks free;
    # r2 needs 4, so despite a free decode slot it waits until r0 finishes
    r0 = Request(0, np.arange(1, 9, dtype=np.int32), 4)
    r1 = Request(1, np.arange(1, 25, dtype=np.int32), 8)
    r2 = Request(2, np.arange(1, 25, dtype=np.int32), 8)
    for r in (r0, r1, r2):
        eng.submit(r)
    rep = eng.run([], honor_arrivals=False)
    assert [r.rid for r in rep.requests] == [0, 1, 2]
    assert [len(r.tokens) for r in rep.requests] == [4, 8, 8]
    assert eng.alloc.free_blocks == eng.alloc.capacity  # all blocks freed


def test_continuous_batching_matches_solo(lms):
    """Sequences joining and leaving the shared batch emit exactly the
    tokens they emit when decoded alone."""
    lm = lms[2]
    max_len = 40
    eng = Engine(lm, CPU, ServeConfig(max_len=max_len, max_batch=3,
                                      block_tokens=8, prefill_chunk=8,
                                      dtype=F32))
    reqs = _requests([5, 11, 3, 16])          # multi-chunk prompts too
    rep = eng.run(reqs, honor_arrivals=False)
    assert len(rep.requests) == 4
    for s in rep.requests:
        assert s.tokens == solo_greedy(lm, reqs[s.rid].prompt, 6, max_len), \
            s.rid


@pytest.mark.parametrize("max_batch", [1, 3])
def test_engine_matches_the_reference_engine(lms, max_batch):
    """The same requests through both packages' engines, the same weights:
    every request's tokens equal."""
    jlm, params, lm = lms
    kw = dict(max_len=48, max_batch=max_batch, block_tokens=8,
              prefill_chunk=16, num_blocks=max_batch * 5 + 1)
    reqs = _requests([5, 20, 3, 16, 30], max_new=7, seed=3)
    jrep = JEngine(jlm, params, NULL_CTX,
                   JServeConfig(dtype=jnp.float32, **kw)).run(
        [JRequest(r.rid, r.prompt, r.max_new) for r in reqs],
        honor_arrivals=False)
    rep = Engine(lm, CPU, ServeConfig(dtype=F32, **kw)).run(
        reqs, honor_arrivals=False)
    assert [r.rid for r in rep.requests] == [r.rid for r in jrep.requests]
    for got, want in zip(rep.requests, jrep.requests):
        assert got.tokens == [int(t) for t in want.tokens], got.rid


def test_every_position_written_lies_in_range(lms, monkeypatch):
    """Attention.decode writes the cache by indexing; the engine keeps each
    position it hands decode_step inside [0, max_len): prompt chunks, the
    live rows' positions and the idle rows' placeholder 0."""
    lm = lms[2]
    max_len = 32
    eng = Engine(lm, CPU, ServeConfig(max_len=max_len, max_batch=4,
                                      block_tokens=8, prefill_chunk=8,
                                      dtype=F32))
    seen, decode_step = [], lm.decode_step

    def recording(tokens, cache, pos, ctx):
        seen.append(pos.reshape(-1, 1) + torch.arange(tokens.shape[1]))
        return decode_step(tokens, cache, pos, ctx)

    monkeypatch.setattr(lm, "decode_step", recording)
    # prompts whose padded length and generation fill max_len: the 24-token
    # prompt's 7 decode steps write positions 24 .. 30 (its last token is
    # emitted, never fed back)
    rep = eng.run(_requests([24, 1, 17, 8, 23], max_new=8),
                  honor_arrivals=False)
    assert [len(r.tokens) for r in rep.requests] == [8] * 5
    written = torch.cat([s.flatten() for s in seen])
    assert int(written.min()) == 0 and int(written.max()) == max_len - 2


def test_measure_serving_and_open_loop_replay(lms):
    """A warm-up replay, reset, the measured closed-loop replay; then an
    open-loop replay that honours the trace's arrival times."""
    lm = lms[2]
    cfg = ServeConfig(max_len=64, max_batch=2, block_tokens=8,
                      prefill_chunk=16, dtype=F32)
    trace = TrafficModel(rate=200.0, prompt_len=12, gen_len=4).trace(5, V)
    rep = measure_serving(lm, CPU, "serve_tp", cfg, trace)
    assert isinstance(rep, ServeReport)
    assert [len(r.tokens) for r in rep.requests] == [4] * 5
    assert rep.wall_s > 0 and rep.percentile(99) >= rep.percentile(50) > 0
    eng = Engine(lm, CPU, cfg)
    rep = eng.run(trace, honor_arrivals=True)
    assert rep.wall_s >= trace[-1].arrival
    assert all(r.ttft >= 0 for r in rep.requests) and eng.idle
    assert eng.alloc.free_blocks == eng.alloc.capacity


def test_serve_cli_smoke_on_the_cpu(tmp_path):
    """The CLI serves every request and writes the reference CLI's keys:
    strategy, mesh, config and the report's summary."""
    out = tmp_path / "serve.json"
    summary = serve.main(["--arch", "qwen1.5-4b", "--smoke", "--device",
                          "cpu", "--closed-loop", "--requests", "4",
                          "--json-out", str(out)])
    written = json.loads(out.read_text())
    want = {"strategy", "mesh", "config"} | set(
        JServeReport([], 1.0).summary())
    assert set(written) == want
    assert set(written["config"]) == {"max_batch", "max_len", "block_tokens",
                                      "prefill_chunk", "kv_shards"}
    assert summary["requests"] == 4 and summary["tokens"] == 4 * 16


def test_refused_layouts_name_their_items(lms, monkeypatch):
    """What raises: a serving mesh with an axis other than "data" and
    "model" (the SUMMA grid), and a decode batch the data axis cannot
    split, for the engine and measure_serving; no CUDA unless the CPU is
    asked for. --strategy auto serves (one device: the p = 1 plan, width
    1; across ranks in tests/test_torch_serve_auto.py), and so do the
    sharded serving layouts: serve_seqkv and kv_shards above 1 on one
    device here, across ranks in tests/test_torch_serve_parallel.py."""
    lm = lms[2]
    cfg = ServeConfig(max_len=32, dtype=F32)
    rep = measure_serving(lm, CPU, "serve_seqkv", cfg, [])
    assert rep.requests == []
    assert Engine(lm, CPU, ServeConfig(max_len=32, kv_shards=2,
                                       prefill_chunk=16,
                                       dtype=F32)).geo.shards == 2
    base = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu"]
    summary = serve.main(base + ["--kv-shards", "2", "--closed-loop",
                                 "--requests", "2"])
    assert summary["requests"] == 2 and summary["tokens"] == 2 * 16
    auto = serve.main(base + ["--strategy", "auto", "--closed-loop",
                              "--requests", "2"])
    assert auto["strategy"] == "serve_tp"
    assert auto["mesh"] == {"data": 1, "model": 1}
    assert auto["tokens"] == 2 * 16
    mesh22 = types.SimpleNamespace(shape={"data": 2, "model": 2}, size=4,
                                   device=torch.device("cpu"))
    ctx22 = ShardingCtx("cpu", mesh=mesh22)
    odd = ServeConfig(max_len=32, max_batch=3, dtype=F32)
    with pytest.raises(ValueError, match="max_batch=3"):
        Engine(lm, ctx22, odd)
    with pytest.raises(ValueError, match="max_batch=3"):
        measure_serving(lm, ctx22, "serve_tp", odd, [])
    grid = types.SimpleNamespace(shape={"data": 1, "model_r": 2,
                                        "model_c": 2}, size=4,
                                 device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="model_r"):
        Engine(lm, ShardingCtx("cpu", mesh=grid), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen1.5-4b", "--smoke"])
