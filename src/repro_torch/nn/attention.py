"""Attention (counterpart of ``repro.nn.attention``) as Qwen1.5-4B runs it:
causal multi-head self-attention with QKV bias and RoPE, as many kv heads as
query heads.

Execution paths, as in the reference:
  * ``plain_attention`` — the full score matrix (tests, tiny shapes);
  * ``flash_attention`` — the reference's chunked online softmax over
    (q-chunk, kv-chunk) blocks in plain torch. Blocks wholly above the
    causal diagonal are skipped, which gives the same numbers as the
    reference's scan over every block: there a skipped block is merged with
    a weight of exactly 0;
  * with ``ctx.use_pallas``, ``Attention.forward`` (the reference's
    ``apply``) and ``prefill`` run the FlashAttention-2 CUDA kernel
    (``kernels/flash_attention``) where the reference would have run its
    chunked path. The kernel computes plain causal self-attention over one
    sequence length with equal q and kv heads, which is all this module
    computes;
  * ``Attention.decode`` — new tokens against a dense KV cache
    (B, shards, max_len/shards, H, D), position t at shard t // span, slot
    t % span (one device reads it as the contiguous view of its
    positions), in plain torch as in the reference. The port writes the
    new keys and values into the cache in place (the reference returns an
    updated copy): a full-width cache is gigabytes.

Across ranks (a ``parallel.sharded.Sharded`` input) ``forward`` re-lays
the activations out at the reference's constraint points: the input with
its sequence whole (``("batch", None, "act_embed")``), q, k and v with their
heads split as ``act_heads``/``act_kv`` say, the output as the residual
stream. The projections are column-parallel on the heads (the biases split
with them and added there, before the constraint, so a constraint that
gathers the heads gathers no bias), RoPE runs at global positions (the
sequence is whole there), the attention itself on the local batch rows and
heads, and ``wo`` is row-parallel (``nn.layers.project``). On the 2-D grid
of the "summa" table the q, k, v and output projections run as SUMMA
(``parallel.summa.attn_qkv``/``attn_out``) off the residual split over
both grid axes, where the shapes divide the grid, as the reference's
``_qkv`` and ``_out`` route them; q, k and v get their bias and are then
re-laid out with their sequence whole before RoPE (elementwise, so the
order changes no number). With a cache (``prefill``, ``decode``) each
leaf is a ``Sharded`` placed by the rules from ``CACHE_AXES``: serve_tp
splits its kv heads, so each rank writes and reads its own heads and
``wo`` is row-parallel; serve_seqkv splits its shard dim, so each rank
holds a contiguous range of positions, writes only the new tokens that
fall in it, and the ranks merge their partial softmaxes as flash decoding
does (``_sharded_decode``). A batch split over "data" (a decode batch on a
(p1, p2) serving mesh) stays split: each data group runs its rows against
its rows of the cache, over its own "model" ranks.

Grouped kv heads, a sliding window and its ring cache, a logit softcap, an
output bias, ``qk_norm``, MLA and cross-attention come with the first ported
model that uses them; a config with fewer kv heads than heads raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..kernels.flash_attention.flash_attention import \
    flash_attention as flash_attention_kernel
from ..kernels.util import largest_divisor
from ..parallel import collectives as coll
from ..parallel import summa
from ..parallel.sharded import Sharded, axes_of, block_index, param_for
from .layers import project
from .module import ShardingCtx, constant, fan_in_normal
from .rotary import apply_rope

NEG_INF = -2.0e38  # large negative for masking in fp32


@dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    use_bias: bool = False          # qwen1.5: bias on QKV only
    rope_base: float = 10000.0
    dtype: torch.dtype | None = None


def _block_attn(q, k, v, qpos, kpos, scale, causal):
    """One (q-block, kv-block) step. q: (B,H,Q,D), k/v: (B,H,K,D). Returns
    the unnormalised output and the row max and sum, all fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return o, m, p.sum(-1)


def flash_attention(q, k, v, *, causal=True, q_chunk=1024, kv_chunk=1024):
    """Chunked flash attention. q: (B, Sq, H, D); k, v: (B, Skv, H, D).

    Chunks are cut to the largest divisor of the sequence length, and query
    i sits at kv position Skv − Sq + i, as in the reference."""
    Sq, Skv = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q_chunk, kv_chunk = largest_divisor(Sq, q_chunk), largest_divisor(Skv,
                                                                      kv_chunk)
    kv_off = Skv - Sq
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, S, D)
    outs = []
    for q_start in range(0, Sq, q_chunk):
        qi = qh[:, :, q_start:q_start + q_chunk]
        qpos = kv_off + q_start + torch.arange(q_chunk, device=q.device)
        o_acc = torch.zeros(qi.shape[:-1] + (v.shape[-1],),
                            dtype=torch.float32, device=q.device)
        m_acc = torch.full(qi.shape[:-1], NEG_INF, dtype=torch.float32,
                           device=q.device)
        s_acc = torch.zeros(qi.shape[:-1], dtype=torch.float32,
                            device=q.device)
        for k_start in range(0, Skv, kv_chunk):
            if causal and k_start > kv_off + q_start + q_chunk - 1:
                continue
            kpos = k_start + torch.arange(kv_chunk, device=q.device)
            o, m, s = _block_attn(qi, kh[:, :, k_start:k_start + kv_chunk],
                                  vh[:, :, k_start:k_start + kv_chunk], qpos,
                                  kpos, scale, causal)
            m_new = torch.maximum(m_acc, m)
            sc_old, sc_new = torch.exp(m_acc - m_new), torch.exp(m - m_new)
            o_acc = o_acc * sc_old[..., None] + o * sc_new[..., None]
            s_acc = s_acc * sc_old + s * sc_new
            m_acc = m_new
        outs.append(o_acc / torch.clamp(s_acc, min=1e-30)[..., None])
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def plain_attention(q, k, v, *, causal=True):
    """Full-matrix attention. q: (B, Sq, H, D); k, v: (B, Skv, H, D)."""
    Sq, Skv = q.shape[1], k.shape[1]
    qpos = Skv - Sq + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    o, m, s = _block_attn(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), qpos, kpos,
                          1.0 / math.sqrt(q.shape[-1]), causal)
    o = o / torch.clamp(s, min=1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)


class Attention(nn.Module):
    """Self-attention with the reference's parameter layout: wq (d, H, hd),
    wk/wv (d, KV, hd), wo (H, hd, d), and bq/bk/bv (heads, hd) when
    ``use_bias``."""

    def __init__(self, cfg: AttentionConfig, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        c = self.cfg = cfg
        if c.n_kv_heads != c.n_heads:
            raise NotImplementedError(
                f"grouped kv heads ({c.n_kv_heads} for {c.n_heads} heads) "
                f"are not ported yet")
        kw = dict(generator=generator, device=device, dtype=c.dtype)
        self.wq = fan_in_normal((c.d_model, c.n_heads, c.head_dim), (0,),
                                axes=("embed", "heads", "head_dim"), **kw)
        self.wk = fan_in_normal((c.d_model, c.n_kv_heads, c.head_dim), (0,),
                                axes=("embed", "kv_heads", "head_dim"), **kw)
        self.wv = fan_in_normal((c.d_model, c.n_kv_heads, c.head_dim), (0,),
                                axes=("embed", "kv_heads", "head_dim"), **kw)
        self.wo = fan_in_normal((c.n_heads, c.head_dim, c.d_model), (0, 1),
                                axes=("heads", "head_dim", "embed"), **kw)
        if c.use_bias:
            self.bq = constant((c.n_heads, c.head_dim), 0.0, device, c.dtype,
                               axes=("heads", "head_dim"))
            self.bk = constant((c.n_kv_heads, c.head_dim), 0.0, device,
                               c.dtype, axes=("kv_heads", "head_dim"))
            self.bv = constant((c.n_kv_heads, c.head_dim), 0.0, device,
                               c.dtype, axes=("kv_heads", "head_dim"))

    def _qkv(self, x, positions):
        """x: (B, S, d) → q, k and v (B, S, H, hd), q and k rotated."""
        q, k, v = ((x @ w.flatten(1)).unflatten(-1, w.shape[1:])
                   for w in (self.wq, self.wk, self.wv))
        if self.cfg.use_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        base = self.cfg.rope_base
        return apply_rope(q, positions, base), apply_rope(k, positions,
                                                          base), v

    def _out(self, o):
        return o.flatten(2) @ self.wo.flatten(0, 1)

    @staticmethod
    def _core(q, k, v, ctx: ShardingCtx, q_chunk: int, kv_chunk: int):
        """Causal attention of (B, S, H, hd) q, k and v: the kernel with
        ``ctx.use_pallas`` (it takes (B, H, S, D) views of the tensors as
        they are, and its output is such a view too), else the chunked
        plain path."""
        if ctx.use_pallas:
            return flash_attention_kernel(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True).transpose(1, 2)
        return flash_attention(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk)

    # -- training / prefill forward (the reference's ``apply``) -------------
    def forward(self, x, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        if isinstance(x, Sharded):
            return self._sharded(x, None, ctx, q_chunk, kv_chunk)
        y, _ = self.prefill(x, None, ctx, q_chunk, kv_chunk)
        return y

    def _sharded_qkv(self, x: Sharded, ctx: ShardingCtx, positions):
        """q, k and v (B, S, H, hd) of a ``Sharded`` input at the
        reference's constraints (``_qkv``), rotated at ``positions`` (B or
        1, S), the sequence whole: q split as ``act_heads``, k and v as
        ``act_kv``."""
        c = self.cfg
        if summa.summa_axes(ctx) is not None and summa.qkv_ok(c, x.mesh,
                                                               x.shape):
            proj = summa.attn_qkv(self, x)
        else:
            x = ctx.constrain(x, ("batch", None, "act_embed"))
            proj = [project(x, w) for w in (self.wq, self.wk, self.wv)]

        def finish(t, b, rotate, act):
            # the bias where the projection leaves its heads (split as the
            # bias is), then the constraint: the same sums, and no gather
            # of the bias where the constraint gathers the heads
            if b is not None:
                t = Sharded(t.local + param_for(b, t, 2).relayout(
                    t.place[2:]).local, t.shape, t.place, t.mesh)
            t = ctx.constrain(t, ("batch", None, act, None))
            y = t.local
            if rotate:
                y = apply_rope(y, _mine(positions, t), c.rope_base)
            return Sharded(y, t.shape, t.place, t.mesh)

        bias = (self.bq, self.bk, self.bv) if c.use_bias else (None,) * 3
        return (finish(proj[0], bias[0], True, "act_heads"),
                finish(proj[1], bias[1], True, "act_kv"),
                finish(proj[2], bias[2], False, "act_kv"))

    def _sharded_out(self, o: Sharded, ctx: ShardingCtx) -> Sharded:
        """``wo`` of the attention output (B, S, H, hd), row-parallel where
        the heads are split, re-laid out as the residual stream."""
        if summa.summa_axes(ctx) is not None and summa.out_ok(
                self.cfg, o.mesh, o.shape):
            y = summa.attn_out(self, o)
        else:
            y = project(o, self.wo, n=2)
        return ctx.constrain(y, ("batch", "seq", "act_embed"))

    def _sharded(self, x: Sharded, cache, ctx: ShardingCtx, q_chunk: int,
                 kv_chunk: int) -> Sharded:
        """``forward`` across ranks (the reference's ``_qkv``, its chunked
        attention and ``_out`` under its constraints); with a cache, the
        prompt's keys and values are written into it first (``prefill``)."""
        q, k, v = self._sharded_qkv(
            x, ctx, torch.arange(x.shape[1], device=x.local.device)[None, :])
        if cache is not None:
            _write_prompt(cache, k, v)
        o = q.map(lambda ql, kl, vl: self._core(ql, kl, vl, ctx, q_chunk,
                                                kv_chunk), k, v)
        return self._sharded_out(o, ctx)

    def prefill(self, x, cache, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        """Attention over the prompt; with a cache, also writes the prompt's
        keys and values into its first S positions (in place), as the
        reference's ``_attn_prefill`` lays them out. Returns (y, cache)."""
        if isinstance(x, Sharded):
            return self._sharded(x, cache, ctx, q_chunk, kv_chunk), cache
        S = x.shape[1]
        q, k, v = self._qkv(x, torch.arange(S, device=x.device)[None, :])
        if cache is not None:
            _flat(cache["k"])[:, :S] = k
            _flat(cache["v"])[:, :S] = v
        return self._out(self._core(q, k, v, ctx, q_chunk, kv_chunk)), cache

    # -- KV cache -----------------------------------------------------------
    def cache_spec(self, batch: int, max_len: int, shards: int = 1,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """Cache layout as meta tensors: k and v of (B, shards,
        max_len/shards, KV, hd), the reference's layout, each recording the
        reference's logical axes (``t.axes``, ``CACHE_AXES``). shards=1:
        the per-head layout; shards = the model axis's size: the
        sequence-sharded (flash-decoding) layout of serve_seqkv."""
        c = self.cfg
        if max_len % shards:
            raise ValueError("max_len must divide shards")
        shape = (batch, shards, max_len // shards, c.n_kv_heads, c.head_dim)
        spec = {}
        for name in ("k", "v"):
            spec[name] = torch.empty(shape, dtype=dtype, device="meta")
            spec[name].axes = CACHE_AXES
        return spec

    def decode(self, x, cache, pos, ctx: ShardingCtx):
        """x: (B, C, d): C new tokens per sequence; pos: an int or a (B,)
        tensor, the index of each sequence's first new token. Token j of row
        b lands at position pos[b] + j, i.e. at shard t // span, slot
        t % span of the cache. Returns (y, cache), the cache updated in
        place. Across ranks x is a ``Sharded`` and so is each cache leaf
        (``_sharded_decode``)."""
        if isinstance(x, Sharded):
            return self._sharded_decode(x, cache, pos, ctx), cache
        B, C, _ = x.shape
        positions = _positions(pos, B, C, x.device)
        q, k_new, v_new = self._qkv(x, positions)
        kc, vc = _flat(cache["k"]), _flat(cache["v"])   # (B, T, H, hd) views
        rows = torch.arange(B, device=x.device)[:, None]
        kc[rows, positions] = k_new.to(kc.dtype)
        vc[rows, positions] = v_new.to(vc.dtype)
        o = self._attend(q, kc, vc, positions, 0, None)
        return self._out(o.to(q.dtype)), cache

    def _sharded_decode(self, x: Sharded, cache: dict, pos,
                        ctx: ShardingCtx) -> Sharded:
        """``decode`` across ranks, each cache leaf a ``Sharded`` placed by
        the rules (``CACHE_AXES``). The projections are ``_sharded``'s; q,
        k and v are then laid out with the cache's rows (split over "data"
        where the rules split the batch) and its kv-head split:

        * ``serve_tp``: the heads split, the cache's span whole (its one
          shard cannot split). Each rank writes and reads its own heads;
          ``wo`` is row-parallel.
        * ``serve_seqkv``: the heads whole, the cache's shard dim split, so
          a rank holds positions [off, off + T). A new token is written
          only by the rank that holds its position (a masked write at its
          slot mod T: never an index outside the block), the scores run
          over the local positions, and the ranks merge as flash decoding
          does: the row max all-reduced (max), then p = exp(s − max) and
          one all-reduce of (p·V, Σp). A rank with no valid key for a row
          (every position it holds past the row's) has s = NEG_INF there,
          so exp(s − max) = 0 exactly: the global max is always a valid
          key's (the row's own new key)."""
        B, C, _ = x.shape
        kc, vc = cache["k"], cache["v"]
        dev = x.local.device
        positions = _positions(pos, B, C, dev)
        q, k, v = self._sharded_qkv(x, ctx, positions)
        heads = (kc.place[0], (), kc.place[3], ())
        q, k, v = (t.relayout(heads) for t in (q, k, v))
        positions = _mine(positions, kc)             # this rank's rows
        B = positions.shape[0]
        kf, vf = _flat(kc.local), _flat(vc.local)    # (B, T, KV_r, hd)
        T = kf.shape[1]
        if C > T:
            raise ValueError(f"{C} new tokens a row exceed the {T} cache "
                             f"positions a rank holds")
        off = block_index(kc.mesh, kc.shape, kc.place)[1].start * kc.shape[2]
        # the C slots of a row are C consecutive positions mod T: distinct,
        # so the rows' writes never collide; a rank that does not hold a
        # position writes back the value its slot holds
        local = positions - off
        mine = ((local >= 0) & (local < T))[..., None, None]
        slot = local.remainder(T)
        rows = torch.arange(B, device=dev)[:, None]
        for buf, new in ((kf, k.local), (vf, v.local)):
            buf[rows, slot] = torch.where(mine, new.to(buf.dtype),
                                          buf[rows, slot])
        split = axes_of(kc.mesh, (kc.place[1],))
        group = kc.mesh.group(split) if split else None
        o = self._attend(q.local, kf, vf, positions, off, group)
        o = Sharded(o.to(q.local.dtype), q.shape, q.place, q.mesh)
        return self._sharded_out(o, ctx)

    def _attend(self, q, kc, vc, positions, off: int, group):
        """Attention of q (B, C, H, hd) at ``positions`` over the cache
        positions off .. off + T − 1 held in kc and vc (B, T, H, hd),
        key t visible to the query at position p when t <= p; with a
        ``group``, merged over its ranks' positions (flash decoding).
        Returns o (B, C, H, hd) in fp32."""
        valid = off + torch.arange(kc.shape[1], device=q.device) \
            <= positions[:, :, None]                          # (B, C, T)
        s = torch.einsum("bchd,bthd->bhct", q, kc.to(q.dtype)).float() \
            * (1.0 / math.sqrt(self.cfg.head_dim))
        s = torch.where(valid[:, None], s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        if group is not None:
            m = coll.all_reduce_max(m, group)
        p = torch.exp(s - m)
        o = torch.einsum("bhct,bthd->bchd", p.to(q.dtype),
                         vc.to(q.dtype)).float()
        total = p.sum(-1)                                     # (B, H, C)
        if group is not None:
            both = coll.all_reduce_sum(torch.cat(
                [o.flatten(), total.flatten()]), group)
            o, total = both[:o.numel()].view(o.shape), \
                both[o.numel():].view(total.shape)
        return o / torch.clamp(total, min=1e-30).transpose(1, 2)[..., None]


# the reference's cache leaf axes: (batch, shards, span, kv heads, head dim);
# "seq" on the shard dim is what serve_seqkv splits
CACHE_AXES = ("batch", "seq", None, "act_kv", None)


def _flat(cache: torch.Tensor) -> torch.Tensor:
    """A cache leaf (B, shards, span, ...) as the (B, shards·span, ...) view
    of its positions (position t at shard t // span, slot t % span);
    raises where no view exists, so a write never lands in a copy."""
    return cache.view(cache.shape[0], -1, *cache.shape[3:])


def _positions(pos, B: int, C: int, device) -> torch.Tensor:
    """(B, C) positions of C new tokens a row from ``pos``, an int or a
    (B,) tensor (an int needs no copy from the host)."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int64, device=device)
    return (pos.to(device, torch.int64).reshape(-1, 1)
            + torch.arange(C, device=device)).expand(B, C)


def _mine(positions: torch.Tensor, t: Sharded) -> torch.Tensor:
    """The rows of (B, C) ``positions`` that this rank holds of ``t``,
    whose first dim is the batch (all of them where that dim is whole; a
    (1, C) row broadcasts)."""
    if positions.shape[0] == 1 or not t.place[0]:
        return positions
    return positions[block_index(t.mesh, t.shape, t.place)[0]]


def _write_prompt(cache: dict, k: Sharded, v: Sharded) -> None:
    """The prompt's keys and values (B, S, KV, hd), whole over the
    sequence, into the first S positions of a ``Sharded`` cache: each rank
    its rows (a batch split over "data"), its positions and its kv
    heads."""
    kc = cache["k"]
    heads = (kc.place[0], (), kc.place[3], ())
    T = kc.local.shape[1] * kc.shape[2]
    off = block_index(kc.mesh, kc.shape, kc.place)[1].start * kc.shape[2]
    n = max(0, min(k.shape[1] - off, T))
    for name, t in (("k", k), ("v", v)):
        buf = _flat(cache[name].local)
        buf[:, :n] = t.relayout(heads).local[:, off:off + n].to(buf.dtype)
