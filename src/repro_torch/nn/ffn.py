"""Feed-forward block (counterpart of ``repro.nn.ffn``): the dense SiLU-GLU
FFN of Qwen1.5-4B, with the reference's weights w_in/w_gate (d, ff) and
w_out (ff, d), no bias. Other activations, the plain (non-GLU) FFN, biases
and Mixture-of-Experts come with the models that use them.

Across ranks (a ``parallel.sharded.Sharded`` input) it is the reference's
``apply`` under its constraints: the input with its sequence whole,
w_in and w_gate column-parallel on ``mlp``, the hidden re-laid out as
``act_mlp``, w_out row-parallel, the output as the residual stream. On the
2-D grid of the "summa" table the three products run as SUMMA
(``parallel.summa.ffn_apply``) where the shapes divide the grid, as the
reference's ``apply`` routes them."""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..parallel import summa
from ..parallel.sharded import Sharded
from .layers import project
from .module import ShardingCtx, fan_in_normal


# jax.nn.silu's formula, x·(1/(1 + exp(−x))), rounded step by step in x's
# dtype as XLA does: in bf16 F.silu (one rounding) differs from it in a
# third of the elements.
def _silu(x):
    return x * (1 / (1 + torch.exp(-x)))


@dataclass(frozen=True)
class FFNConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"
    dtype: torch.dtype | None = None


class FFN(nn.Module):
    """silu(x·w_in) ⊙ (x·w_gate) · w_out."""

    def __init__(self, cfg: FFNConfig, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        c = self.cfg = cfg
        if c.activation != "silu":
            raise NotImplementedError(f"activation {c.activation!r} is not "
                                      f"ported yet")
        kw = dict(generator=generator, device=device, dtype=c.dtype)
        self.w_in = fan_in_normal((c.d_model, c.d_ff), (0,),
                                  axes=("embed", "mlp"), **kw)
        self.w_gate = fan_in_normal((c.d_model, c.d_ff), (0,),
                                    axes=("embed", "mlp"), **kw)
        self.w_out = fan_in_normal((c.d_ff, c.d_model), (0,),
                                   axes=("mlp", "embed"), **kw)

    def forward(self, x, ctx: ShardingCtx):
        if not isinstance(x, Sharded):
            return (_silu(x @ self.w_in) * (x @ self.w_gate)) @ self.w_out
        if summa.summa_axes(ctx) and summa.ffn_ok(self.cfg, x.mesh, x.shape):
            return ctx.constrain(summa.ffn_apply(self, x, _silu),
                                 ("batch", "seq", "act_embed"))
        x = ctx.constrain(x, ("batch", None, "act_embed"))
        h = project(x, self.w_in).map(lambda a, g: _silu(a) * g,
                                      project(x, self.w_gate))
        h = ctx.constrain(h, ("batch", None, "act_mlp"))
        return ctx.constrain(project(h, self.w_out),
                             ("batch", "seq", "act_embed"))
