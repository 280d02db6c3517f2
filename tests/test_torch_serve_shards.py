"""The sharded-span KV cache on one device: the cache's ``shards`` dim
(the reference's (B, shards, max_len/shards, KV, hd) layout, token t at
shard t // span, slot t % span) in ``Attention.cache_spec``,
``TransformerLM.cache_spec`` (a span the shards do not divide keeps one
shard, as the reference's ``Block.cache_spec``), ``cache_geometry`` and
``pool_spec``, ``prefill`` and ``decode`` on it, and the engine with
``kv_shards`` 2 and 4 against the JAX package's engine.

The model is the smoke Qwen1.5-4B (2 layers, d 64, 4 heads of 16, vocab
512) in fp32 with the JAX ``tree_init`` weights carried over by
repro_torch.bridge. Bars: a sharded-span cache is a view of the one-shard
cache's positions, so its logits equal the one-shard cache's bit for bit;
against the reference's decode (its softmax over (shards, span) jointly,
another order of the sums) within 1e-5 of the logit scale; the engine's
tokens equal the reference engine's (fp32: the logits agree to ~1e-6,
far from any tie here); the engine's pool against a dense cache that the
same chunks and tokens filled at exactly 0.0 (``max_abs_diff``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import TransformerLM as JLM
from repro.nn.module import NULL_CTX, tree_abstract, tree_init
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import cache_geometry as j_cache_geometry
from repro.serve import pool_spec as j_pool_spec
from repro_torch.bridge import cache_from_jax, load_jax_params
from repro_torch.configs import get_config
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.module import ShardingCtx, zeros_like_spec
from repro_torch.serve import (Engine, Request, ServeConfig, cache_geometry,
                               max_abs_diff, pool_spec)

CPU = ShardingCtx("cpu")
F32 = torch.float32
ARCH = "qwen1.5-4b"


def _fp32(cfg, dt):
    sub = {k: dataclasses.replace(getattr(cfg, k), dtype=dt)
           for k in ("attn", "ffn") if getattr(cfg, k) is not None}
    return dataclasses.replace(cfg, dtype=dt, **sub)


@pytest.fixture(scope="module")
def lms():
    """The fp32 smoke Qwen in both packages, the port's holding JAX's
    weights."""
    jlm = JLM(_fp32(j_get_config(ARCH).smoke_model, jnp.float32))
    params = tree_init(jlm.params_spec(), jax.random.PRNGKey(0))
    lm = TransformerLM(_fp32(get_config(ARCH).smoke_model, F32),
                       device=torch.device("cpu"), generator=None)
    load_jax_params(lm, jax.tree.map(np.asarray, params))
    return jlm, params, lm


def _shapes(tree) -> list:
    return [{k: tuple(t.shape) for k, t in layer.items()}
            for layer in tree["blocks"]]


@pytest.mark.parametrize("max_len,shards", [(64, 1), (64, 2), (64, 4),
                                            (30, 4)])
def test_cache_spec_shards_match_jax(lms, max_len, shards):
    """(B, shards, max_len/shards, KV, hd) as the reference lays it out;
    30 positions do not split into 4 shards, so every layer keeps one, as
    the reference's Block.cache_spec falls back; Attention.cache_spec
    itself raises there, as the reference's does."""
    jlm, _, lm = lms
    spec = lm.cache_spec(2, max_len, shards=shards, dtype=F32)
    want = cache_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32),
        tree_abstract(jlm.cache_spec(2, max_len, shards=shards,
                                     dtype=jnp.float32))))
    assert _shapes(spec) == _shapes(want)
    sh = shards if max_len % shards == 0 else 1
    assert spec["blocks"][0]["k"].shape == (2, sh, max_len // sh, 4, 16)
    assert spec["blocks"][0]["k"].axes == ("batch", "seq", None, "act_kv",
                                           None)
    if sh != shards:
        with pytest.raises(ValueError, match="must divide shards"):
            lm.blocks[0].mixer.cache_spec(2, max_len, shards=shards)


@pytest.mark.parametrize("shards", [2, 4])
def test_geometry_and_pool_spec_match_jax(lms, shards):
    jlm, _, lm = lms
    got = cache_geometry(lm, 64, shards=shards, block_tokens=16, dtype=F32)
    want = j_cache_geometry(jlm, 64, shards=shards, block_tokens=16,
                            dtype=jnp.float32)
    for f in ("shards", "span", "bspan", "n_blk", "kv_bytes_per_token",
              "block_tokens", "max_len"):
        assert getattr(got, f) == getattr(want, f), f
    jpool = cache_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32),
        tree_abstract(j_pool_spec(jlm, want, 9, jnp.float32))))
    assert _shapes(pool_spec(lm, got, 9, F32)) == _shapes(jpool)
    # the reference's refusal of blocks that do not split into the shards;
    # shards that do not split max_len leave every layer one shard, as in
    # the reference (80 positions, 3 shards), and a span then not whole
    # blocks is refused as the reference refuses it
    for pkg, geometry, lm_ in (("jax", j_cache_geometry, jlm),
                               ("port", cache_geometry, lm)):
        with pytest.raises(ValueError, match="multiple of kv_shards"):
            geometry(lm_, 64, shards=shards, block_tokens=shards + 1)
        assert geometry(lm_, 80, shards=3, block_tokens=16).shards == 1, pkg
        with pytest.raises(ValueError, match="must divide the cache span"):
            geometry(lm_, 66, shards=4, block_tokens=16)


def _prefill_and_decode(lm, prompt, steps, max_len, shards):
    """The logits of a prompt pass, then of ``steps`` greedy decode steps
    and of a 4-token chunk at the decoded position, on a fresh cache of
    ``shards`` shards; and the cache."""
    cache = zeros_like_spec(lm.cache_spec(1, max_len, shards=shards,
                                          dtype=F32), "cpu")
    out = []
    with torch.no_grad():
        lg, cache = lm.prefill(prompt, cache, CPU)
        out.append(lg)
        pos = prompt.shape[1]
        for _ in range(steps):
            lg, cache = lm.decode_step(lg[:, -1:].argmax(-1), cache, pos, CPU)
            out.append(lg)
            pos += 1
        chunk = torch.arange(1, 5)[None]
        lg, cache = lm.decode_step(chunk, cache, torch.tensor([pos]), CPU)
        out.append(lg)
    return out, cache


@pytest.mark.parametrize("shards", [2, 4])
def test_prefill_and_decode_on_a_sharded_span_cache(lms, shards):
    """The prompt pass writes its keys at (t // span, t % span) and the
    decode steps read and write there: the logits equal the one-shard
    cache's bit for bit, and the cache holds the same values at the same
    positions; the reference's decode on its own sharded cache agrees
    within 1e-5 of the logit scale."""
    jlm, params, lm = lms
    max_len = 32
    prompt = torch.from_numpy(np.random.default_rng(shards).integers(
        1, 512, (1, 11)).astype(np.int32))
    one, cache1 = _prefill_and_decode(lm, prompt, 5, max_len, 1)
    got, cache = _prefill_and_decode(lm, prompt, 5, max_len, shards)
    for a, b in zip(got, one, strict=True):
        assert torch.equal(a, b)
    for la, lb in zip(cache["blocks"], cache1["blocks"]):
        for name in ("k", "v"):
            assert torch.equal(la[name].reshape(1, max_len, 4, 16),
                               lb[name][:, 0])
    # the reference, fed the port's greedy tokens
    jcache = jax.tree.map(jnp.zeros_like, tree_init(
        jlm.cache_spec(1, max_len, shards=shards, dtype=jnp.float32),
        jax.random.PRNGKey(1)))
    lg, jcache = jlm.prefill(params, jnp.asarray(prompt.numpy()), jcache,
                             attn_impl="plain")
    want = [np.asarray(lg)]
    for i in range(5):
        tok = jnp.asarray(got[i][:, -1:].argmax(-1).numpy())
        lg, jcache = jlm.decode_step(params, tok, jcache, 11 + i)
        want.append(np.asarray(lg))
    lg, jcache = jlm.decode_step(params, jnp.arange(1, 5)[None], jcache,
                                 jnp.asarray([16]))
    want.append(np.asarray(lg))
    for a, b in zip(got, want, strict=True):
        scale = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * scale


def _requests(lens, max_new=7, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, 512, size=L,
                                               dtype=np.int32),
                    max_new=max_new) for i, L in enumerate(lens)]


@pytest.mark.parametrize("shards", [2, 4])
def test_engine_kv_shards_matches_the_reference_engine(lms, shards):
    """The same requests through both packages' engines with ``kv_shards``
    2 and 4 (16-token blocks of 16 // shards slots a shard): every
    request's tokens equal."""
    jlm, params, lm = lms
    kw = dict(max_len=64, max_batch=3, block_tokens=16, prefill_chunk=16,
              kv_shards=shards)
    reqs = _requests([5, 20, 3, 16, 30, 40])
    jrep = JEngine(jlm, params, NULL_CTX,
                   JServeConfig(dtype=jnp.float32, **kw)).run(
        [JRequest(r.rid, r.prompt, r.max_new) for r in reqs],
        honor_arrivals=False)
    eng = Engine(lm, CPU, ServeConfig(dtype=F32, **kw))
    assert (eng.geo.shards, eng.geo.span, eng.geo.bspan) == (
        shards, 64 // shards, 16 // shards)
    rep = eng.run(reqs, honor_arrivals=False)
    assert [r.rid for r in rep.requests] == [r.rid for r in jrep.requests]
    for got, want in zip(rep.requests, jrep.requests):
        assert got.tokens == [int(t) for t in want.tokens], got.rid
    assert eng.alloc.free_blocks == eng.alloc.capacity


@pytest.mark.parametrize("shards", [2, 4])
def test_engine_pool_equals_the_dense_cache(lms, shards):
    """One request through the engine (one decode slot): its blocks of the
    pool against a dense ``shards``-shard cache that the same padded
    prompt chunks and the same tokens filled, at exactly 0.0."""
    _, _, lm = lms
    C, max_len = 16, 64
    eng = Engine(lm, CPU, ServeConfig(max_len=max_len, max_batch=1,
                                      block_tokens=16, prefill_chunk=C,
                                      kv_shards=shards, dtype=F32))
    req = _requests([21], max_new=9)[0]
    toks = eng.run([req], honor_arrivals=False).requests[0].tokens
    pad = np.zeros(32, np.int32)
    pad[:21] = req.prompt
    dense = zeros_like_spec(lm.cache_spec(1, max_len, shards=shards,
                                          dtype=F32), "cpu")
    with torch.no_grad():
        for p0 in (0, C):
            _, dense = lm.decode_step(torch.from_numpy(pad[None, p0:p0 + C]),
                                      dense, torch.tensor([p0]), CPU)
        for i, t in enumerate(toks[:-1]):
            _, dense = lm.decode_step(torch.tensor([[t]]), dense,
                                      torch.tensor([21 + i]), CPU)
    # the allocator hands out ascending ids: the request held blocks 1..n
    n = eng.geo.blocks_for(32 + 9)
    tables = torch.arange(1, eng.geo.n_blk + 1)[None]
    tables[:, n:] = 0
    assert max_abs_diff(eng.pool, tables, dense, eng.geo, 21 + 8) == 0.0
