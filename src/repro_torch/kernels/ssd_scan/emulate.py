"""The arithmetic of the tensor-core ``ssd_chunk`` kernel
(``csrc/ssd_chunk.cu``) in plain torch, on any device: for holding the
kernel's numerics against references where the kernel cannot run, and for
planting one TF32 pass as a fault on the card.

Per (batch, chunk, head), every operand padded with zeros as the kernel pads
it (the chunk to whole tiles of 64 positions, P to 64, N to 128):

* cum is the kernel's in-block prefix sum of dt·A: 32 positions a step, each
  step a Hillis–Steele scan plus the carry of the step before.
* Each contraction splits both operands into hi = TF32 rounded to nearest,
  ties away from zero (``cvt.rna.tf32.f32``, on the int32 bits) and lo =
  v − hi, which the tensor core reads as TF32 by dropping its low 13 bits,
  and every k-step of 8 adds lo_a·hi_b, hi_a·lo_b, then hi_a·hi_b to an fp32
  accumulator (each product of two TF32 values is exact in fp32):
  scores = C·Bᵀ over N; y = W·x over the positions j, with W = scores ·
  exp(cum_i − cum_j) · dt_j for j ≤ i, else 0; state = (w·x)ᵀ·B over j,
  with w_j = exp(cum_end − cum_j) · dt_j.

The kernel skips the j tiles above the diagonal; here they are computed and
add exact zeros. W's exponent here is torch.exp; the kernel's is the SFU's
(``__expf``), a few ulp apart where exp(cum_i − cum_j) is not negligible.
``products`` keeps, per contraction (scores, y, state), hi·hi alone (1:
one TF32 pass) or all three; ``truncate`` rounds every addition into an
accumulator toward zero instead of to nearest."""
from __future__ import annotations

import torch

from ..conv2d_gemm.emulate import _truncated_f32, tf32_rna, tf32_trunc
from ..util import cdiv

TILE = 64           # positions per tile
K_STEP = 8          # K of one wgmma .tf32
N_PAD, P_PAD = 128, 64
# logical k of the staged operands' physical column 0..7 within a k-step:
# the scores accumulator holds columns 2t, 2t + 1 of each group of 8, a tf32
# A fragment columns t, t + 4 (t = lane % 4)
KPERM = (0, 2, 4, 6, 1, 3, 5, 7)


def block_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last dim in the kernel's order: steps of
    32 positions, each a Hillis–Steele scan, plus the previous step's last
    value."""
    Q = v.shape[-1]
    steps = cdiv(Q, 32)
    w = torch.nn.functional.pad(v, (0, steps * 32 - Q)).unflatten(-1,
                                                                  (steps, 32))
    for off in (1, 2, 4, 8, 16):
        w = torch.cat([w[..., :off], w[..., off:] + w[..., :-off]], -1)
    out, carry = [], torch.zeros_like(w[..., 0, 0])
    for s in range(steps):
        out.append(w[..., s, :] + carry[..., None])
        carry = out[-1][..., -1]
    return torch.cat(out, -1)[..., :Q]


def _mma(a: torch.Tensor, b: torch.Tensor, products: int,
         truncate: bool) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, Nn), K a multiple of 8, as 3xTF32 k-steps
    (or hi·hi alone) into an fp32 accumulator."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - products:]
    acc = a.new_zeros((*a.shape[:-1], b.shape[-1]))
    for k0 in range(0, a.shape[-1], K_STEP):
        ks = slice(k0, k0 + K_STEP)
        for ta, tb in terms:
            if truncate:
                acc = _truncated_f32(acc.double()
                                     + ta[..., ks].double() @ tb[..., ks, :]
                                     .double())
            else:
                acc = acc + ta[..., ks] @ tb[..., ks, :]
    return acc


def emulate(x, dt, A, Bm, Cm, Q: int, *, products=(3, 3, 3),
            truncate: bool = False):
    """The kernel's (y_intra (B, S, H, P), states (B, S/Q, H, P, N), decays
    (B, S/Q, H)) for chunks of Q positions, on x's device (fp32 matmuls there
    must not use TF32). Shapes as ``ref.ssd_chunk_ref``."""
    Bsz, S, H, P = x.shape
    N, nC = Bm.shape[-1], S // Q
    Qp = cdiv(Q, TILE) * TILE

    def per_head(t, width):      # (B, S, H, D) -> (B, nC, H, Qp, width)
        t = t.reshape(Bsz, nC, Q, H, -1).transpose(2, 3)
        return torch.nn.functional.pad(t, (0, width - t.shape[-1],
                                           0, Qp - Q))

    xc, Bc, Cc = per_head(x, P_PAD), per_head(Bm, N_PAD), per_head(Cm, N_PAD)
    dtc = dt.reshape(Bsz, nC, Q, H).transpose(2, 3)           # (B, nC, H, Q)
    cum = block_cumsum(dtc * A[:, None])
    dtp = torch.nn.functional.pad(dtc, (0, Qp - Q))
    cump = torch.nn.functional.pad(cum, (0, Qp - Q))
    p_sc, p_y, p_st = products

    scores = _mma(Cc, Bc.transpose(-1, -2), p_sc, truncate)    # (.., Qp, Qp)
    i = torch.arange(Qp, device=x.device)
    keep = (i[None, :] <= i[:, None]) & (i[:, None] < Q)
    w = torch.where(keep, scores * torch.exp(cump[..., :, None]
                                             - cump[..., None, :])
                    * dtp[..., None, :], 0.0)
    y = _mma(w, xc, p_y, truncate)[..., :Q, :P]               # (.., Q, P)
    y = y.transpose(2, 3).reshape(Bsz, S, H, P)

    cend = cum[..., -1:]
    wts = torch.nn.functional.pad(torch.exp(cend - cum) * dtc, (0, Qp - Q))
    st = _mma((xc * wts[..., None]).transpose(-1, -2), Bc, p_st, truncate)
    return y, st[..., :P, :N].contiguous(), torch.exp(cend[..., 0])
