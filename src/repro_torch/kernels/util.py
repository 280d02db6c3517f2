"""Helpers shared by the kernels' plain versions and the layers.

* The conv sites' SAME-padding rule and weight layout. XLA's SAME split is
  asymmetric (``lo = total // 2``, the odd pixel goes below/right) while
  ``torch.nn.functional.conv2d(padding=...)`` pads symmetrically, so the
  port pads explicitly with these numbers.
* The port's copies of the JAX package's block-size helpers
  (``largest_divisor``, ``resolve_block_rows``). The CUDA kernels use fixed
  tiles and mask their ragged edges, so they need neither; the chunked
  attention of ``nn/attention.py`` cuts S into chunks exactly as the
  reference does, with ``largest_divisor``.
"""
from __future__ import annotations

import math

import torch

# a divisor smaller than this serializes a row grid badly enough that
# padding to the requested block is cheaper (the reference's rule)
MIN_BLOCK_ROWS = 16


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


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``cap`` (O(√n); cap clamped to
    [1, n])."""
    n = int(n)
    cap = max(1, min(int(cap), n))
    if n % cap == 0:
        return cap
    best = 1
    for d in range(2, math.isqrt(n) + 1):
        if n % d == 0:
            if best < d <= cap:
                best = d
            if best < n // d <= cap:
                best = n // d
    return best


def resolve_block_rows(rows: int, block: int,
                       min_block: int = MIN_BLOCK_ROWS) -> tuple[int, int]:
    """``(block_rows, padded_rows)`` for a grid over ``rows`` independent
    rows: the largest divisor of ``rows`` ≤ ``block`` when it is exact or at
    least ``min_block``; otherwise (a prime row count) the requested block,
    with the rows padded up to a multiple of it."""
    cap = max(1, min(int(block), int(rows)))
    br = largest_divisor(rows, cap)
    if br == cap or br >= min_block:
        return br, rows
    return cap, -(-rows // cap) * cap
