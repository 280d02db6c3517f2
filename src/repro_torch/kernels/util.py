"""Conv helpers shared by the conv kernel's plain version, ``nn.layers.Conv``
and ``max_pool``: XLA's SAME-padding rule and the weight layout handed to
``torch.nn.functional.conv*``.

The JAX package's ``kernels/util.py`` resolves TPU block sizes
(``largest_divisor``, ``resolve_block_rows``); the CUDA kernels of this port
use fixed tiles and mask their ragged edges, so none of that is carried over.
What every conv site of the port does need is the SAME split that XLA uses,
which is asymmetric: ``lo = total // 2`` and the odd pixel goes below/right.
``torch.nn.functional.conv2d(padding=...)`` pads symmetrically, so the port
pads explicitly with these numbers.
"""
from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(lo, hi) padding of one spatial dim of extent ``n`` for a SAME window
    of width ``k`` and stride ``s``: the output has ``ceil(n / s)`` entries."""
    total = max((cdiv(n, s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(*K, I, O) weight → the (O, I, *K) operand of ``F.conv*``, a view."""
    nd = w.dim() - 2
    return w.permute(nd + 1, nd, *range(nd))
