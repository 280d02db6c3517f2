"""Plain PyTorch version of ``rmsnorm`` (the counterpart of the JAX
package's ``kernels/rmsnorm/ref.py``): the kernel wrapper sends CPU tensors
here, ``nn.layers.RMSNorm`` runs it when ``use_pallas`` is off, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,). fp32 mean of squares, ``rsqrt(ms + eps)``,
    times the fp32 scale, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
