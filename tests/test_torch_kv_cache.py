"""The port's paged KV cache (serve/kv_cache.py) against the JAX package's,
on a tiny fp32 MHA LM (2 layers, d 32, 4 heads of 8, vocab 64; the port
has no grouped kv heads, so not the reference test's GQA model) with the
JAX ``tree_init`` parameters carried over by repro_torch.bridge.

The allocator as tests/test_serve.py pins it; the geometry's fields and
refusals equal the reference's; ``gather_view`` and ``scatter_blocks``
equal the reference's exactly on the same fp32 pool (pure data movement);
and the port's own paged-vs-dense check with two bars. The reference's
``test_paged_vs_dense_exact`` pins two things: paged against dense (it
holds at exactly 0.0) and the dense cache's chunked ``decode_step`` logits
against the full forward, which differ by 1.19e-6 in fp32 there, two
orders of reduction pinned as if bitwise equal. So here paged against dense
is exactly 0.0 (logits and pool: the same computation on the same values),
and chunked against the full forward within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LMConfig as JLMConfig
from repro.models import TransformerLM as JLM
from repro.nn import AttentionConfig as JAttn
from repro.nn import FFNConfig as JFFN
from repro.nn.module import tree_abstract, tree_init
from repro.serve import cache_geometry as j_cache_geometry
from repro.serve import gather_view as j_gather_view
from repro.serve import pool_spec as j_pool_spec
from repro.serve import scatter_blocks as j_scatter_blocks
from repro_torch.bridge import cache_from_jax, load_jax_params
from repro_torch.configs import get_config
from repro_torch.models.transformer import LMConfig, TransformerLM
from repro_torch.nn.attention import AttentionConfig
from repro_torch.nn.ffn import FFNConfig
from repro_torch.nn.module import ShardingCtx, zeros_like_spec
from repro_torch.serve import (BlockAllocator, cache_geometry, gather_view,
                               max_abs_diff, pool_spec, scatter_blocks)

V, D = 64, 32
CPU = ShardingCtx("cpu")
CHUNK_TOL = 1e-5
F32 = torch.float32


def mk_lms(n_layers=2):
    """The tiny MHA LM in both packages, the port's holding the JAX
    parameters."""
    jlm = JLM(JLMConfig(name="tiny", vocab=V, d_model=D, n_layers=n_layers,
                        attn=JAttn(D, 4, 4, 8, dtype=jnp.float32),
                        ffn=JFFN(D, 64, dtype=jnp.float32),
                        dtype=jnp.float32))
    params = tree_init(jlm.params_spec(), jax.random.PRNGKey(0))
    tlm = TransformerLM(LMConfig(name="tiny", vocab=V, d_model=D,
                                 n_layers=n_layers,
                                 attn=AttentionConfig(D, 4, 4, 8, dtype=F32),
                                 ffn=FFNConfig(D, 64, dtype=F32), dtype=F32),
                        device=CPU.device, generator=None)
    load_jax_params(tlm, jax.tree.map(np.asarray, params))
    return jlm, params, tlm


@pytest.fixture(scope="module")
def lms():
    return mk_lms()


def _random_like(spec_tree, seed):
    """fp32 numpy leaves of a JAX spec tree's shapes, seeded."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        tree_abstract(spec_tree))


def _equal(port_tree: dict, jax_tree) -> None:
    """Leaf for leaf, bit for bit."""
    want = cache_from_jax(jax.tree.map(np.asarray, jax_tree))
    assert len(port_tree["blocks"]) == len(want["blocks"])
    for got, exp in zip(port_tree["blocks"], want["blocks"]):
        assert set(got) == set(exp)
        for name in got:
            assert got[name].shape == exp[name].shape, name
            assert torch.equal(got[name], exp[name]), name


def test_block_allocator():
    a = BlockAllocator(5)                    # block 0 reserved
    assert a.capacity == 4
    assert a.alloc(3) == [1, 2, 3]
    assert a.alloc(2) is None                # only 1 block left
    assert a.alloc(1) == [4]
    a.free([2, 3])
    assert sorted(a.alloc(2)) == [2, 3]      # freed blocks are reused
    with pytest.raises(ValueError):
        a.free([2, 2])                       # double free
    with pytest.raises(ValueError):
        a.free([0])                          # the null block is never freed
    with pytest.raises(ValueError):
        BlockAllocator(1)


@pytest.mark.parametrize("max_len,block_tokens",
                         [(32, 8), (64, 16), (48, 16), (64, 64)])
def test_cache_geometry_matches_jax(lms, max_len, block_tokens):
    jlm, _, tlm = lms
    want = j_cache_geometry(jlm, max_len, block_tokens=block_tokens,
                            dtype=jnp.float32)
    got = cache_geometry(tlm, max_len, block_tokens=block_tokens, dtype=F32)
    for f in ("shards", "span", "bspan", "n_blk", "kv_bytes_per_token",
              "block_tokens", "max_len"):
        assert getattr(got, f) == getattr(want, f), f
    for n in (1, 7, max_len - 1, max_len, 10 * max_len):
        assert got.blocks_for(n) == want.blocks_for(n)


@pytest.mark.parametrize("case", ["span_not_blocks", "block_not_span",
                                  "ssm_cache"])
def test_cache_geometry_refuses_what_jax_refuses(lms, case):
    """A block span that does not divide the cache span, and an SSM cache
    (Mamba-2: no pageable attention cache), with the reference's reason."""
    jlm, _, tlm = lms
    max_len, bt = {"span_not_blocks": (40, 16), "block_not_span": (32, 5),
                   "ssm_cache": (32, 16)}[case]
    if case == "ssm_cache":
        from repro.configs import get_config as j_get_config
        jlm = JLM(j_get_config("mamba2-780m").smoke_model)
        tlm = TransformerLM(get_config("mamba2-780m").smoke_model,
                            device=torch.device("meta"), generator=None)
    match = ("paged pool serves" if case == "ssm_cache"
             else "must divide the cache span")
    with pytest.raises(ValueError, match=match):
        j_cache_geometry(jlm, max_len, block_tokens=bt)
    with pytest.raises(ValueError, match=match):
        cache_geometry(tlm, max_len, block_tokens=bt)


def test_pool_spec_matches_jax(lms):
    jlm, _, tlm = lms
    geo = cache_geometry(tlm, 32, block_tokens=8, dtype=F32)
    jgeo = j_cache_geometry(jlm, 32, block_tokens=8, dtype=jnp.float32)
    jspec = tree_abstract(j_pool_spec(jlm, jgeo, 9, jnp.float32))
    want = cache_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jspec))
    got = pool_spec(tlm, geo, 9, F32)
    for g, w in zip(got["blocks"], want["blocks"], strict=True):
        assert {k: (tuple(t.shape), t.dtype) for k, t in g.items()} == \
            {k: (tuple(t.shape), t.dtype) for k, t in w.items()}


@pytest.fixture(scope="module")
def pools(lms):
    """The same random fp32 pool (9 blocks of 8 slots, max_len 32) in both
    packages' layouts, and a block table of 3 sequences with no block
    shared (a shared block would be written twice in no set order)."""
    jlm = lms[0]
    jgeo = j_cache_geometry(jlm, 32, block_tokens=8, dtype=jnp.float32)
    jpool = _random_like(j_pool_spec(jlm, jgeo, 9, jnp.float32), 0)
    tables = np.array([[3, 1, 7, 2], [5, 8, 4, 6], [0, 0, 0, 0]], np.int32)
    return jgeo, jpool, tables


def test_gather_view_matches_jax_exactly(pools):
    _, jpool, tables = pools
    view = gather_view(cache_from_jax(jpool), torch.from_numpy(tables).long())
    _equal(view, j_gather_view(jax.tree.map(jnp.asarray, jpool),
                               jnp.asarray(tables)))
    assert view["blocks"][0]["k"].shape == (3, 1, 32, 4, 8)


@pytest.mark.parametrize("jidx", [[[1], [3], [0]], [[0, 1], [2, 3], [1, 2]]],
                         ids=["decode", "prefill"])
def test_scatter_blocks_matches_jax_exactly(lms, pools, jidx):
    """One touched block a row (a decode step) and a range of two (a
    prefill chunk), the third row on the null block."""
    jlm, _, _ = lms
    jgeo, jpool, tables = pools
    jidx = np.array(jidx, np.int32)
    dense = _random_like(jlm.cache_spec(3, 32, dtype=jnp.float32), 1)
    want = j_scatter_blocks(jax.tree.map(jnp.asarray, jpool),
                            jnp.asarray(tables), jax.tree.map(jnp.asarray,
                                                              dense),
                            jnp.asarray(jidx))
    # the null row's block 0 is written by one row only here
    got = scatter_blocks(cache_from_jax(jpool), torch.from_numpy(tables).long(),
                         cache_from_jax(dense), torch.from_numpy(jidx).long())
    _equal(got, want)


def test_paged_vs_dense_exact(lms):
    """Chunked prefill through the paged pool against the dense cache, every
    chunk: logits and cache contents exactly equal; the dense chunks'
    logits against the full forward within CHUNK_TOL."""
    _, _, lm = lms
    S, max_len, C = 16, 32, 8
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, V, (1, S)).astype(np.int32))
    with torch.no_grad():
        full, _ = lm(toks, CPU)
        geo = cache_geometry(lm, max_len, block_tokens=8, dtype=F32)
        pool = zeros_like_spec(pool_spec(lm, geo, 9, F32), "cpu")
        tables = torch.tensor([[1, 2, 3, 4]])
        dense = zeros_like_spec(lm.cache_spec(1, max_len, dtype=F32), "cpu")
        for k in range(S // C):
            p0 = torch.tensor([k * C])
            chunk = toks[:, k * C:(k + 1) * C]
            lgr, dense = lm.decode_step(chunk, dense, p0, CPU)
            view = gather_view(pool, tables)
            lgp, view = lm.decode_step(chunk, view, p0, CPU)
            jidx = (p0 % geo.span // geo.bspan)[:, None] \
                + torch.arange(C // geo.bspan)[None]
            pool = scatter_blocks(pool, tables, view, jidx)
            assert float((lgp - lgr).abs().max()) == 0.0
            np.testing.assert_allclose(lgr.numpy(),
                                       full[:, k * C:(k + 1) * C].numpy(),
                                       rtol=CHUNK_TOL, atol=CHUNK_TOL)
            assert max_abs_diff(pool, tables, dense, geo, (k + 1) * C) == 0.0
