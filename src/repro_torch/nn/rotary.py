"""Rotary position embeddings (counterpart of ``repro.nn.rotary``): the
split-half convention of the Llama/Qwen reference implementations, angles in
fp32. The partial rotary dim of MLA comes with MLA."""
from __future__ import annotations

import torch


def rope_frequencies(dim: int, base: float = 10000.0,
                     device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies of a rotary dim, fp32."""
    if dim % 2:
        raise ValueError(f"rotary dim must be even, got {dim}")
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (base ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotate x: (..., seq, heads, head_dim) by positions broadcastable to
    (..., seq); the first half of the features pairs with the second."""
    inv_freq = rope_frequencies(x.shape[-1], base, x.device)
    angles = positions[..., None].float() * inv_freq     # (..., seq, hd/2)
    angles = angles[..., None, :]                        # over the heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
