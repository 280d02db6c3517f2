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
    (B, 1, max_len, H, D), in plain torch as in the reference. The port
    writes the new keys and values into the cache in place (the reference
    returns an updated copy): a full-width cache is gigabytes.

Across ranks (a ``parallel.sharded.Sharded`` input) ``forward`` re-lays
the activations out at the reference's constraint points: the input with
its sequence whole (``("batch", None, "act_embed")``), q, k and v with their
heads split as ``act_heads``/``act_kv`` say, the output as the residual
stream. The projections are column-parallel on the heads (the biases split
with them), RoPE runs at global positions (the sequence is whole there),
the attention itself on the local batch rows and heads, and ``wo`` is
row-parallel (``nn.layers.project``). On the 2-D grid of the "summa"
table the q, k, v and output projections run as SUMMA
(``parallel.summa.attn_qkv``/``attn_out``) off the residual split over
both grid axes, where the shapes divide the grid, as the reference's
``_qkv`` and ``_out`` route them; q, k and v are then re-laid out with
their sequence whole before the bias and RoPE (elementwise, so the order
changes no number). The caches (``prefill``, ``decode``) run on one
device.

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
from ..parallel import summa
from ..parallel.sharded import Sharded, param_for
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
            return self._sharded(x, ctx, q_chunk, kv_chunk)
        y, _ = self.prefill(x, None, ctx, q_chunk, kv_chunk)
        return y

    def _sharded(self, x: Sharded, ctx: ShardingCtx, q_chunk: int,
                 kv_chunk: int) -> Sharded:
        """``forward`` across ranks (the reference's ``_qkv``, its chunked
        attention and ``_out`` under its constraints)."""
        c = self.cfg
        grid = summa.summa_axes(ctx) is not None
        if grid and summa.qkv_ok(c, x.mesh, x.shape):
            proj = summa.attn_qkv(self, x)
        else:
            x = ctx.constrain(x, ("batch", None, "act_embed"))
            proj = [project(x, w) for w in (self.wq, self.wk, self.wv)]
        positions = torch.arange(x.shape[1], device=x.local.device)[None, :]

        def finish(t, b, rotate, act):
            t = ctx.constrain(t, ("batch", None, act, None))
            y = t.local
            if b is not None:
                y = y + param_for(b, t, 2).relayout(t.place[2:]).local
            if rotate:
                y = apply_rope(y, positions, c.rope_base)
            return Sharded(y, t.shape, t.place, t.mesh)

        bias = (self.bq, self.bk, self.bv) if c.use_bias else (None,) * 3
        q = finish(proj[0], bias[0], True, "act_heads")
        k = finish(proj[1], bias[1], True, "act_kv").relayout(q.place)
        v = finish(proj[2], bias[2], False, "act_kv").relayout(q.place)
        o = q.map(lambda ql, kl, vl: self._core(ql, kl, vl, ctx, q_chunk,
                                                kv_chunk), k, v)
        if grid and summa.out_ok(c, o.mesh, o.shape):
            y = summa.attn_out(self, o)
        else:
            y = project(o, self.wo, n=2)
        return ctx.constrain(y, ("batch", "seq", "act_embed"))

    def prefill(self, x, cache, ctx: ShardingCtx, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        """Attention over the prompt; with a cache, also writes the prompt's
        keys and values into its first S positions (in place), as the
        reference's ``_attn_prefill`` lays them out. Returns (y, cache)."""
        S = x.shape[1]
        q, k, v = self._qkv(x, torch.arange(S, device=x.device)[None, :])
        if cache is not None:
            cache["k"][:, 0, :S] = k
            cache["v"][:, 0, :S] = v
        return self._out(self._core(q, k, v, ctx, q_chunk, kv_chunk)), cache

    # -- KV cache -----------------------------------------------------------
    def cache_spec(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """Cache layout as meta tensors: k and v of (B, 1, max_len, KV, hd),
        the reference's layout with one shard."""
        c = self.cfg
        shape = (batch, 1, max_len, c.n_kv_heads, c.head_dim)
        return {name: torch.empty(shape, dtype=dtype, device="meta")
                for name in ("k", "v")}

    def decode(self, x, cache, pos, ctx: ShardingCtx):
        """x: (B, C, d): C new tokens per sequence; pos: an int or a (B,)
        tensor, the index of each sequence's first new token. Token j of row
        b lands at position pos[b] + j. Returns (y, cache), the cache updated
        in place."""
        B, C, _ = x.shape
        if not isinstance(pos, torch.Tensor):   # no copy from the host
            pos = torch.full((), pos, dtype=torch.int64, device=x.device)
        positions = (pos.to(x.device, torch.int64).reshape(-1, 1)
                     + torch.arange(C, device=x.device)).expand(B, C)
        q, k_new, v_new = self._qkv(x, positions)
        kc, vc = cache["k"][:, 0], cache["v"][:, 0]     # (B, T, H, hd) views
        rows = torch.arange(B, device=x.device)[:, None]
        kc[rows, positions] = k_new.to(kc.dtype)
        vc[rows, positions] = v_new.to(vc.dtype)

        # key t is visible to the query at position p when t <= p
        valid = torch.arange(kc.shape[1], device=x.device) \
            <= positions[:, :, None]                          # (B, C, T)
        s = torch.einsum("bchd,bthd->bhct", q, kc.to(q.dtype)).float() \
            * (1.0 / math.sqrt(self.cfg.head_dim))
        s = torch.where(valid[:, None], s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhct,bthd->bchd", p.to(q.dtype),
                         vc.to(q.dtype)).float()
        o = o / torch.clamp(p.sum(-1), min=1e-30).transpose(1, 2)[..., None]
        return self._out(o.to(q.dtype)), cache
