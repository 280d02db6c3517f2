"""Plain PyTorch versions of the Mamba-2 SSD chunk computation (the
counterparts of the JAX package's ``kernels/ssd_scan/ref.py`` and of what
its Pallas kernel computes): the kernel wrapper sends CPU tensors here, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.

* ``ssd_ref`` — the naive per-token recurrence, the oracle.
* ``ssd_chunk_ref`` — what the kernel computes for every (batch, chunk):
  the intra-chunk output, the chunk's state and its decay.
* ``ssd_combine`` — the inter-chunk recurrence and the ``y_inter`` term that
  the reference keeps outside its kernel, with an optional initial state
  folded in as ``SSDBlock._ssd`` folds it.

Shapes: x (B, S, H, P); dt (B, S, H) (after softplus); A (H,) (negative);
Bm, Cm (B, S, H, N), groups already repeated (a stride-0 view will do). All
float32.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, Bm, Cm):
    """Naive SSD recurrence → (y (B, S, H, P), final_state (B, H, P, N))."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A)                              # (B, H)
        state = state * dA[:, :, None, None] + \
            torch.einsum("bh,bhn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t], state))
    return torch.stack(ys, 1), state


def ssd_chunk_ref(x, dt, A, Bm, Cm, chunk: int):
    """Per (batch, chunk of ``chunk`` positions), with cum = cumsum(dt·A)
    over the chunk and L_ij = exp(cum_i − cum_j) for j ≤ i, else 0:

    y_intra (B, S, H, P) = Σ_j (C_i·B_j) L_ij dt_j x_j;
    states (B, nC, H, P, N) = Σ_j exp(cum_end − cum_j) dt_j x_j ⊗ B_j;
    decays (B, nC, H) = exp(cum_end). All fp32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nC = S // Q
    xc = x.reshape(Bsz, nC, Q, H, P)
    dtc = dt.reshape(Bsz, nC, Q, H)
    Bc = Bm.reshape(Bsz, nC, Q, H, N)
    Cc = Cm.reshape(Bsz, nC, Q, H, N)
    cum = torch.cumsum(dtc * A, dim=2)                          # (B, nC, Q, H)

    scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    cum_h = cum.transpose(2, 3)                                 # (B, nC, H, Q)
    diff = cum_h[..., :, None] - cum_h[..., None, :]            # (.., Qi, Qj)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(causal, torch.exp(diff), 0.0)
    w = scores * L * dtc.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", w, xc).reshape(Bsz, S, H, P)

    decay_end = torch.exp(cum[:, :, -1:] - cum)                 # (B, nC, Q, H)
    states = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", decay_end * dtc, Bc, xc)
    return y, states, torch.exp(cum[:, :, -1])


def ssd_combine(y_intra, states, decays, dt, A, Cm, init_state=None):
    """The inter-chunk part: the chunk states carried across chunks, and
    their contribution to every position → (y (B, S, H, P), final_state
    (B, H, P, N)). ``init_state`` (B, H, P, N), the state before the first
    chunk, decays into every chunk after it, as in ``SSDBlock._ssd``."""
    Bsz, nC, H = decays.shape
    S, N = Cm.shape[1], Cm.shape[-1]
    Q = S // nC
    # the reference's associative scan, (da, sa) ∘ (db, sb) = (da·db,
    # sb + sa·db), applied in order: dec_c[c] = Π_{k≤c} decays[k], st_c[c]
    # the state at the end of chunk c
    dec_c, st_c = [decays[:, 0]], [states[:, 0]]
    for c in range(1, nC):
        dec_c.append(dec_c[-1] * decays[:, c])
        st_c.append(states[:, c] + st_c[-1] * decays[:, c, :, None, None])
    dec_c, st_c = torch.stack(dec_c, 1), torch.stack(st_c, 1)
    if init_state is not None:
        st_c = st_c + dec_c[..., None, None] * init_state[:, None]
    first = init_state[:, None] if init_state is not None \
        else torch.zeros_like(st_c[:, :1])
    prev = torch.cat([first, st_c[:, :-1]], dim=1)              # (B, nC, H, P, N)

    in_decay = torch.exp(torch.cumsum(dt.reshape(Bsz, nC, Q, H) * A, dim=2))
    Cc = Cm.reshape(Bsz, nC, Q, H, N)
    y_inter = torch.einsum("bcjh,bcjhn,bchpn->bcjhp", in_decay, Cc, prev)
    return y_intra + y_inter.reshape(y_intra.shape), st_c[:, -1]
