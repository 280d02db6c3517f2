"""Mamba-2 (SSD, state-space duality) block, the counterpart of
``repro.nn.ssm``, with the reference's parameters and numerics.

Chunked SSD [arXiv:2405.21060]: within a chunk the output is a masked,
decay-weighted, attention-like quadratic form; across chunks a linear
recurrence carries the (heads, head_dim, state) tensor. The input
projection is kept as separate z/x/B/C/dt matrices, as in the reference.

Execution paths:
  * ``_ssd`` — the reference's chunked SSD, line for line, in plain torch;
    with ``ctx.use_pallas`` it runs the CUDA kernel instead
    (``kernels/ssd_scan``), which computes the same chunks. B and C reach
    the kernel as ``expand`` views over the heads when there is one group:
    the repeat is never made.
  * ``forward`` (the reference's ``apply``) and ``prefill`` (the body of
    its ``_recurrent_prefill``), the latter starting from the cache's state
    and writing the final state and the conv tails into the cache in place;
  * ``decode`` — one token against the O(1) cache, in plain torch as in the
    reference (it has no kernel there), the cache updated in place.

The reference rounds each bf16 elementwise op on its own; the port keeps
its op order (the conv's sum of K products, then the bias, then SiLU).

Across ranks (a ``parallel.sharded.Sharded`` input) ``forward`` is the
reference's ``apply`` under its constraints: the five projections off the
input with its sequence whole (z and x column-parallel on ``mlp``, dt on
``heads``), the depthwise convs on whole sequences and the local channels,
x re-laid out with its d_inner split as the reference's
``("batch", None, "act_heads", None)`` splits the heads before the
(B, S, H, P) view, the SSD on the local heads, the gated norm (its sum of
squares all-reduced where d_inner is split) and ``out_proj`` row-parallel.
The caches (``prefill``, ``decode``) run on one device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd_scan.ssd_scan import ssd_chunk
from ..parallel.sharded import Sharded, param_for, placement
from .ffn import _silu
from .layers import RMSNorm, project
from .module import ShardingCtx, constant, fan_in_normal, with_axes


@dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64          # P
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    dtype: torch.dtype | None = None

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def bc_dim(self) -> int:
        return self.n_groups * self.d_state


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) (F.softplus switches to x
    above 20; the two agree in fp32)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _heads(m, n_heads: int):
    """(B, S, G, N) → (B, S, H, N), group g serving heads g·H/G .. : a
    stride-0 view for one group, else a repeat."""
    G = m.shape[2]
    if G == 1:
        return m.expand(*m.shape[:2], n_heads, m.shape[3])
    return m.repeat_interleave(n_heads // G, dim=2)


class SSDBlock(nn.Module):
    def __init__(self, cfg: SSMConfig, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=c.dtype)
        self.w_z = fan_in_normal((c.d_model, c.d_inner), (0,),
                                 axes=("embed", "mlp"), **kw)
        self.w_x = fan_in_normal((c.d_model, c.d_inner), (0,),
                                 axes=("embed", "mlp"), **kw)
        self.w_B = fan_in_normal((c.d_model, c.bc_dim), (0,),
                                 axes=("embed", "state"), **kw)
        self.w_C = fan_in_normal((c.d_model, c.bc_dim), (0,),
                                 axes=("embed", "state"), **kw)
        self.w_dt = fan_in_normal((c.d_model, c.n_heads), (0,),
                                  axes=("embed", "heads"), **kw)
        self.conv_x = fan_in_normal((c.d_conv, c.d_inner), (0,),
                                    axes=("conv_k", "mlp"), **kw)
        self.conv_B = fan_in_normal((c.d_conv, c.bc_dim), (0,),
                                    axes=("conv_k", "state"), **kw)
        self.conv_C = fan_in_normal((c.d_conv, c.bc_dim), (0,),
                                    axes=("conv_k", "state"), **kw)
        self.conv_b_x = constant((c.d_inner,), 0.0, device, c.dtype,
                                 axes=("mlp",))
        self.conv_b_B = constant((c.bc_dim,), 0.0, device, c.dtype,
                                 axes=("state",))
        self.conv_b_C = constant((c.bc_dim,), 0.0, device, c.dtype,
                                 axes=("state",))
        self.dt_bias = with_axes(nn.Parameter(
            self._dt_bias_init(generator, device)), ("heads",))
        # A = -exp(a_log) = -(1 .. H)
        self.a_log = with_axes(nn.Parameter(torch.log(torch.arange(
            1, c.n_heads + 1, dtype=torch.float32, device=device))),
            ("heads",))
        self.d_skip = constant((c.n_heads,), 1.0, device, axes=("heads",))
        self.norm = RMSNorm(c.d_inner, device=device, axis_name="mlp")
        self.out_proj = fan_in_normal((c.d_inner, c.d_model), (0,),
                                      axes=("mlp", "embed"), **kw)

    def _dt_bias_init(self, generator, device):
        """softplus⁻¹ of dt drawn log-uniform in [dt_min, dt_max]."""
        c = self.cfg
        u = torch.empty(c.n_heads, dtype=torch.float32,
                        device=device if generator is None
                        else generator.device)
        if u.device.type == "meta":
            return u.to(device)
        u.uniform_(generator=generator)
        lo, hi = np.log(c.dt_min), np.log(c.dt_max)
        dt = torch.exp(u * (hi - lo) + lo)
        return torch.log(torch.expm1(dt)).to(device)

    # ------------------------------------------------------------------
    @staticmethod
    def _causal_conv(x, w, b, act=True):
        """Depthwise causal conv along seq. x: (B, S, C); w: (K, C)."""
        K = w.shape[0]
        pad = F.pad(x, (0, 0, K - 1, 0))
        out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(K))
        out = out + b
        return _silu(out) if act else out

    def _ssd(self, x, dt, A, Bm, Cm, init_state=None, *, ctx: ShardingCtx):
        """Chunked SSD. x: (B,S,H,P) dt: (B,S,H) A: (H,) Bm/Cm: (B,S,G,N).

        Returns (y (B,S,H,P), final_state (B,H,P,N))."""
        c = self.cfg
        B_, S, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        Q = min(c.chunk, S)
        if S % Q:
            raise ValueError(f"seq {S} must divide chunk {Q}")
        if ctx.use_pallas:
            return ssd_chunk(x, dt, A, _heads(Bm, H), _heads(Cm, H),
                             chunk=Q, init_state=init_state)
        nC = S // Q
        xc = x.reshape(B_, nC, Q, H, P)
        dtc = dt.reshape(B_, nC, Q, H)
        Bc = _heads(Bm, H).reshape(B_, nC, Q, H, N)
        Cc = _heads(Cm, H).reshape(B_, nC, Q, H, N)
        dA = dtc * A                      # (B,nC,Q,H) log-decay (A negative)
        cum = torch.cumsum(dA, dim=2)

        # intra-chunk (quadratic, attention-like)
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
        # The reference takes where(causal, exp(diff), 0): exp of the upper
        # triangle too, where diff = cum_i − cum_j > 0 grows with the chunk.
        # At Mamba-2 780m's widths (A to −48, chunk 256) it overflows to inf,
        # and the backward's 0·inf makes every gradient NaN (ROADMAP caveat
        # m). Masking diff first gives the same values (exp(−inf) = 0) and
        # finite gradients.
        Lmask = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                           float("-inf")))
        scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
        y_intra = torch.einsum("bcijh,bcjh,bcijh,bcjhp->bcihp",
                               scores, dtc, Lmask, xc)

        # chunk states
        decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
        states = torch.einsum("bcjh,bcjh,bcjhn,bcjhp->bchpn",
                              decay_to_end, dtc, Bc, xc)

        # inter-chunk recurrence: the reference's associative scan,
        # (da, sa) ∘ (db, sb) = (da·db, sb + sa·db), applied in order
        chunk_decay = torch.exp(cum[:, :, -1, :])
        dec_c, st_c = [chunk_decay[:, 0]], [states[:, 0]]
        for k in range(1, nC):
            dec_c.append(dec_c[-1] * chunk_decay[:, k])
            st_c.append(states[:, k]
                        + st_c[-1] * chunk_decay[:, k, :, None, None])
        dec_c, st_c = torch.stack(dec_c, 1), torch.stack(st_c, 1)
        if init_state is not None:
            st_c = st_c + dec_c[..., None, None] * init_state[:, None]
        prev = torch.cat([
            (init_state[:, None] if init_state is not None
             else torch.zeros_like(st_c[:, :1])), st_c[:, :-1]], dim=1)

        in_decay = torch.exp(cum)
        y_inter = torch.einsum("bcjh,bcjhn,bchpn->bcjhp", in_decay, Cc, prev)
        y = (y_intra + y_inter).reshape(B_, S, H, P)
        return y, st_c[:, -1]

    # ------------------------------------------------------------------
    def _project(self, u):
        return (u @ self.w_z, u @ self.w_x, u @ self.w_B, u @ self.w_C,
                u @ self.w_dt)

    def _gate_out(self, y, z, x, u, ctx: ShardingCtx):
        """D skip, then (B, S, d_inner) in u's dtype gated by silu(z),
        normed and projected back: the reference's tail of ``apply``."""
        c = self.cfg
        y = y + x.float() * self.d_skip[None, None, :, None]
        y = y.reshape(*u.shape[:2], c.d_inner).to(u.dtype)
        y = y * _silu(z)
        return self.norm(y, ctx) @ self.out_proj

    def forward(self, u, ctx: ShardingCtx):
        """u: (B, S, d_model) → (B, S, d_model)."""
        if isinstance(u, Sharded):
            return self._sharded(u, ctx)
        y, _ = self.prefill(u, None, ctx)
        return y

    def _sharded(self, u: Sharded, ctx: ShardingCtx) -> Sharded:
        c = self.cfg
        mesh = u.mesh
        B_, S, _ = u.shape
        u = ctx.constrain(u, ("batch", None, "act_embed"))
        z, xs, Bm, Cm, dt = (project(u, w) for w in (
            self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt))
        z = ctx.constrain(z, ("batch", None, "act_mlp"))
        xs = ctx.constrain(xs, ("batch", None, "act_mlp"))

        def conv(t: Sharded, w, b) -> Sharded:
            ch = t.place[-1:]
            w = param_for(w, t, 2).relayout(((),) + ch).local
            b = param_for(b, t, 2).relayout(ch).local
            return t.map(lambda tl: self._causal_conv(tl, w, b))

        # d_inner split as the heads: block k of H heads is block k of
        # their H·P channels
        heads = placement(mesh, ctx.pspec(("batch", None, "act_heads", None),
                                          (B_, S, c.n_heads, c.head_dim)))
        xs = conv(xs, self.conv_x, self.conv_b_x).relayout(heads[:3])
        Bm = conv(Bm, self.conv_B, self.conv_b_B).relayout(heads[:2] + ((),))
        Cm = conv(Cm, self.conv_C, self.conv_b_C).relayout(heads[:2] + ((),))
        dt = dt.relayout(heads[:3])
        if c.n_groups != 1 and heads[2]:
            raise NotImplementedError("B and C in several groups beside "
                                      "split heads are not ported")
        dt_bias, a_log, d_skip = (param_for(p, dt, 2).relayout(heads[2:3])
                                  .local for p in (self.dt_bias, self.a_log,
                                                   self.d_skip))
        x4 = xs.local.unflatten(-1, (-1, c.head_dim))
        dtf = _softplus(dt.local.float() + dt_bias)
        y, _ = self._ssd(x4.float(), dtf, -torch.exp(a_log),
                         Bm.local.unflatten(-1, (c.n_groups, c.d_state))
                         .float(),
                         Cm.local.unflatten(-1, (c.n_groups, c.d_state))
                         .float(), ctx=ctx)
        y = (y + x4.float() * d_skip[None, None, :, None]).flatten(2)
        y = Sharded(y.to(u.local.dtype), xs.shape, xs.place, mesh).map(
            lambda yl, zl: yl * _silu(zl), z)
        return ctx.constrain(project(self.norm(y, ctx), self.out_proj),
                             ("batch", "seq", "act_embed"))

    def prefill(self, u, cache, ctx: ShardingCtx):
        """Forward over the prompt, from the cache's state when a cache is
        given; then writes the final state and the last d_conv − 1 inputs of
        each conv into it, in place. Returns (y, cache)."""
        c = self.cfg
        B_, S, _ = u.shape
        z, xs, Bm, Cm, dt = self._project(u)
        if cache is not None:
            tail = slice(S - (c.d_conv - 1), S)
            for name, t in (("conv_x", xs), ("conv_B", Bm), ("conv_C", Cm)):
                cache[name].copy_(t[:, tail])
        xs = self._causal_conv(xs, self.conv_x, self.conv_b_x)
        Bm = self._causal_conv(Bm, self.conv_B, self.conv_b_B)
        Cm = self._causal_conv(Cm, self.conv_C, self.conv_b_C)
        xs = xs.reshape(B_, S, c.n_heads, c.head_dim)
        Bm = Bm.reshape(B_, S, c.n_groups, c.d_state)
        Cm = Cm.reshape(B_, S, c.n_groups, c.d_state)
        dtf = _softplus(dt.float() + self.dt_bias)
        A = -torch.exp(self.a_log)
        y, final = self._ssd(xs.float(), dtf, A, Bm.float(), Cm.float(),
                             init_state=None if cache is None
                             else cache["state"].float(), ctx=ctx)
        if cache is not None:
            cache["state"].copy_(final)
        return self._gate_out(y, z, xs, u, ctx), cache

    # ------------------------------------------------------------------
    def cache_spec(self, batch: int, dtype: torch.dtype = torch.float32
                   ) -> dict:
        """Cache layout as meta tensors: the SSM state (B, H, P, N) and the
        conv tails (B, d_conv − 1, ·)."""
        c = self.cfg

        def meta(*shape):
            return torch.empty(shape, dtype=dtype, device="meta")
        return {"state": meta(batch, c.n_heads, c.head_dim, c.d_state),
                "conv_x": meta(batch, c.d_conv - 1, c.d_inner),
                "conv_B": meta(batch, c.d_conv - 1, c.bc_dim),
                "conv_C": meta(batch, c.d_conv - 1, c.bc_dim)}

    @staticmethod
    def _conv_step(buf, new, w, b, act=True):
        """One-token depthwise conv over the (K−1)-tail buffer → (out, the
        new tail). The K products are summed in fp32 and rounded once, as
        the reference's einsum in ``new``'s dtype does."""
        full = torch.cat([buf, new[:, None].to(buf.dtype)], dim=1)
        out = torch.einsum("bkc,kc->bc", full.to(new.dtype).float(),
                           w.float()).to(new.dtype) + b
        out = _silu(out) if act else out
        return out, full[:, 1:]

    def decode(self, u, cache, pos, ctx: ShardingCtx):
        """Single-token recurrent step. u: (B, 1, d_model); ``pos`` is not
        read (the state carries the position). Returns (y, cache), the cache
        updated in place."""
        c = self.cfg
        B_ = u.shape[0]
        z, x, Bm, Cm, dt = self._project(u)
        x, conv_x = self._conv_step(cache["conv_x"], x[:, 0], self.conv_x,
                                    self.conv_b_x)
        Bm, conv_B = self._conv_step(cache["conv_B"], Bm[:, 0], self.conv_B,
                                     self.conv_b_B)
        Cm, conv_C = self._conv_step(cache["conv_C"], Cm[:, 0], self.conv_C,
                                     self.conv_b_C)
        x = x.reshape(B_, c.n_heads, c.head_dim).float()
        Bh = _heads(Bm.reshape(B_, 1, c.n_groups, c.d_state).float(),
                    c.n_heads)[:, 0]
        Ch = _heads(Cm.reshape(B_, 1, c.n_groups, c.d_state).float(),
                    c.n_heads)[:, 0]
        dt1 = _softplus(dt[:, 0].float() + self.dt_bias)
        dA = torch.exp(dt1 * -torch.exp(self.a_log))
        state = cache["state"] * dA[:, :, None, None] + \
            torch.einsum("bh,bhn,bhp->bhpn", dt1, Bh, x)
        y = torch.einsum("bhn,bhpn->bhp", Ch, state)
        cache["state"].copy_(state)
        cache["conv_x"].copy_(conv_x)
        cache["conv_B"].copy_(conv_B)
        cache["conv_C"].copy_(conv_C)
        return self._gate_out(y[:, None], z, x[:, None], u, ctx), cache
