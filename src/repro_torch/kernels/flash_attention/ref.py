"""Plain PyTorch version of ``flash_attention`` (the counterpart of the JAX
package's ``kernels/flash_attention/ref.py``): the full score matrix and an
fp32 softmax. The kernel wrapper sends CPU tensors here, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, D) → (B, H, S, D), in q's dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if causal:
        S, T = s.shape[-2], s.shape[-1]
        mask = torch.ones((S, T), dtype=torch.bool, device=s.device).tril(T - S)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
