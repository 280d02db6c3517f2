"""The arithmetic of the tensor-core ``ssd_chunk`` kernel
(``csrc/ssd_chunk.cu``), which cannot run here, emulated in plain torch and
held against the port's plain ``ssd_chunk_ref``, the JAX package's Pallas
``ssd_chunk`` (interpret mode) and its naive ``ssd_ref``, on the same seeded
numpy inputs.

The emulation (``repro_torch.kernels.ssd_scan.emulate``) follows the
kernel: the in-block prefix sum of dt·A, tiles zero-padded to 64 positions,
P 64 and N 128, and each of the three contractions (C·Bᵀ, W·x, (w·x)ᵀ·B) as
3×TF32 k-steps of 8 into fp32 accumulators, rounding to nearest or
truncating every addition.

Bar: the one ``chip_smoke.py`` holds the kernel to, max |out − plain| ≤
1e-4 · max |plain| per output. At the Mamba-2 780m chunk (Q 256, N 128, P
64, A down to −48) the emulation reads ~0.09 of it, nearly all from the
prefix sum's order (with torch.cumsum's it reads < 0.02); one TF32 pass in
any one contraction reads 2–5× the bar, which is why every operand is
split."""
import math

import numpy as np
import pytest
import torch

from repro.kernels import ssd_chunk as j_ssd_chunk
from repro.kernels import ssd_ref as j_ssd_ref
from repro_torch.kernels.ssd_scan import emulate as emu
from repro_torch.kernels.ssd_scan.emulate import KPERM, emulate
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref, ssd_combine

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one box: keep torch's share small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, P, N, seed=3, groups=1):
    """x, dt, A, Bm, Cm as fp32 numpy arrays, drawn as ``chip_smoke.py``
    draws them from the model's init: dt = softplus(N(0, 0.5) + dt_bias),
    dt_bias from softplus⁻¹ of [1e-3, 0.1] log-uniform, A = −(1 .. H)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    u = rng.random(H)
    dt_bias = np.log(np.expm1(np.exp(
        u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))))
    dt = np.logaddexp(0.5 * rng.standard_normal((B, S, H)) + dt_bias, 0.0)
    A = -np.arange(1, H + 1)
    Bm = rng.standard_normal((B, S, groups, N))
    Cm = rng.standard_normal((B, S, groups, N))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _torch(x, dt, A, Bm, Cm):
    """Torch tensors, B and C expanded over the heads as ``SSDBlock`` passes
    them (stride-0 views for one group)."""
    H, N = x.shape[2], Bm.shape[-1]
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    t[3:] = [m.expand(*m.shape[:2], H, N) for m in t[3:]]
    return t


def _ratio(got, ref) -> float:
    """max over the outputs of max |got − ref| / (TOL · max |ref|)."""
    return max(float((g - r).abs().max()) / (TOL * float(r.abs().max()))
               for g, r in zip(got, ref))


@pytest.fixture(scope="module")
def mamba_chunk():
    """Two chunks of the Mamba-2 780m prompt pass's SSD: B 1, S 512, 48
    heads (A down to −48), P 64, N 128, Q 256; with the plain outputs."""
    t = _torch(*_inputs(1, 512, 48, 64, 128))
    return t, ssd_chunk_ref(*t, 256)


@pytest.mark.parametrize("truncate", [False, True])
def test_three_tf32_holds_the_bar_at_the_mamba_chunk(mamba_chunk, truncate):
    t, ref = mamba_chunk
    got = emulate(*t, 256, truncate=truncate)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _ratio(got, ref) <= 0.2


def test_the_split_itself_costs_a_few_hundredths(mamba_chunk, monkeypatch):
    """With torch.cumsum's order for cum (the plain version's), 3×TF32 reads
    < 0.01 of the bar rounding to nearest and < 0.03 truncating: the rest
    of the 0.09 above is the prefix sum's order, as in the FMA kernel."""
    monkeypatch.setattr(emu, "block_cumsum", lambda v: torch.cumsum(v, -1))
    t, ref = mamba_chunk
    assert _ratio(emulate(*t, 256), ref) <= 0.01
    assert _ratio(emulate(*t, 256, truncate=True), ref) <= 0.03


@pytest.mark.parametrize("products", [(1, 3, 3), (3, 1, 3), (3, 3, 1)],
                         ids=["scores", "y", "state"])
def test_one_tf32_pass_in_any_contraction_exceeds_the_bar(mamba_chunk,
                                                          products):
    """hi·hi alone in any one of the three products fails the bar (chip_smoke's
    fault_tf32_once plants it in all three on the card)."""
    t, ref = mamba_chunk
    assert _ratio(emulate(*t, 256, products=products), ref) > 1.0


# (S, H, P, N, chunk): test_ssd_chunk_sweep's two shapes
@pytest.mark.parametrize("S,H,P,N,chunk", [(64, 4, 8, 16, 16),
                                           (128, 2, 16, 8, 32)])
def test_emulation_matches_jax_pallas_and_the_naive_recurrence(S, H, P, N,
                                                               chunk):
    """Through the inter-chunk recurrence: against the Pallas kernel (same
    chunked algorithm, 1e-4) and the per-token recurrence (the reference's
    own 2e-3)."""
    arrays = _inputs(2, S, H, P, N, seed=5, groups=H)
    x, dt, A, Bm, Cm = _torch(*arrays)
    y, final = ssd_combine(*emulate(x, dt, A, Bm, Cm, chunk), dt, A, Cm)
    y_p, st_p = j_ssd_chunk(*arrays, chunk=chunk, interpret=True)
    y_n, st_n = j_ssd_ref(*arrays)
    for got, pallas, naive in ((y, y_p, y_n), (final, st_p, st_n)):
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(naive),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 1000, 4, 64, 128, 250),    # a ragged chunk: 250 = 3 tiles + 58 rows
    (2, 64, 4, 8, 16, 16),         # P and N padded to 64 and 128
], ids=["ragged_Q250", "P8_N16"])
def test_padded_tiles_hold_the_bar(B, S, H, P, N, chunk):
    """Rows past Q, columns past P and N are zeros the kernel computes with;
    they add exact zeros, and every output holds the bar."""
    t = _torch(*_inputs(B, S, H, P, N, seed=6))
    got = emulate(*t, chunk)
    ref = ssd_chunk_ref(*t, chunk)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
    assert _ratio(got, ref) <= 0.2


def test_k_permuted_operand_feeds_the_accumulator_as_the_a_fragment():
    """y += W·x with W's A fragment taken from the scores accumulator's
    registers as they are, and x's staged K order permuted by KPERM within
    each group of 8, is W·x. Fragment layouts (PTX ISA, wgmma .tf32): lane t
    of warp w holds accumulator d[4i + 2h + e] at (16w + t/4 + 8h, 8i +
    2(t%4) + e) and A register a[q] at (16w + t/4 + 8(q%2), t%4 + 4(q/2))
    of each k-step."""
    rng = np.random.default_rng(7)
    W, x = rng.standard_normal((64, 64)), rng.standard_normal((64, 64))
    a_phys = np.zeros((64, 64))
    for w in range(4):
        for t in range(32):
            d = {4 * i + 2 * h + e: W[16 * w + t // 4 + 8 * h,
                                      8 * i + 2 * (t % 4) + e]
                 for i in range(8) for h in range(2) for e in range(2)}
            for ks in range(8):
                a = [d[4 * ks + 2 * (q % 2) + q // 2] for q in range(4)]
                for q in range(4):
                    a_phys[16 * w + t // 4 + 8 * (q % 2),
                           8 * ks + t % 4 + 4 * (q // 2)] = a[q]
    order = [8 * (k // 8) + KPERM[k % 8] for k in range(64)]
    b_phys = x[order]             # physical column k holds position order[k]
    np.testing.assert_allclose(a_phys @ b_phys, W @ x, rtol=1e-12,
                               atol=1e-12)
    assert sorted(order) == list(range(64))
