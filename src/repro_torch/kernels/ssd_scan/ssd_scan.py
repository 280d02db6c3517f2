"""Wrapper of the Mamba-2 SSD chunk CUDA kernel (``csrc/ssd_chunk.cu``).

Same contract as the JAX package's ``kernels/ssd_scan/ssd_scan.py``
``ssd_chunk``: x (B, S, H, P), dt (B, S, H) after softplus, A (H,)
negative, Bm and Cm (B, S, H, N) with the groups repeated, chunks of
``Q = largest_divisor(S, chunk)`` positions; returns y (B, S, H, P) and the
final state (B, H, P, N). All float32, which is all the model sends:
another dtype raises ``TypeError``. ``init_state`` (B, H, P, N), the state
before the first position, is folded into the inter-chunk recurrence as
``SSDBlock._ssd`` folds it.

The kernel computes what the Pallas kernel computes for every (batch,
chunk): the intra-chunk output, the chunk state and the chunk decay, on the
tensor cores as 3×TF32 (``emulate.py`` is its arithmetic in plain torch). A
call launches a prep kernel (B's tile images as hi and lo parts, and cum, dt
and the state weights, into scratch the wrapper allocates) and the main
kernel; it counts as one launch. The inter-chunk recurrence over the S/Q
chunks and the ``y_inter`` term stay in torch (``ref.ssd_combine``), as the
reference keeps them in host code.

Each tensor is read through its own (b, s, h) element strides, with its
last dim unit-stride: ``SSDBlock`` passes the one group of Mamba-2's B and
C as (B, S, H, N) ``expand`` views whose head stride is 0, so the repeat
over the heads is never made.

A CPU tensor goes to the plain version (``ref.ssd_chunk_ref``); a CUDA
tensor launches the kernel or raises. There is no backward kernel, so a
call that autograd would have to differentiate raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import load
from ..util import largest_divisor
from .ref import ssd_chunk_ref, ssd_combine

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
_PREP_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
MAX_HEAD_DIM = 64      # P: one 64-wide wgmma tile of the output
MAX_STATE = 128        # N: the C and B tiles are staged whole
MAX_CHUNK = 8192       # Q: the contract since the first kernel
TILE = 64              # positions per tile of the kernel
# fp32 of one tile's images, B's and B^T's, each hi then lo
TILE_IMAGES = 4 * TILE * MAX_STATE


@functools.cache
def _kernel_fns():
    lib = load("ssd_chunk")
    fn, prep = lib.ssd_chunk_f32, lib.ssd_chunk_prep_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    prep.argtypes, prep.restype = _PREP_ARGTYPES, ctypes.c_int
    return fn, prep


def _check(x, dt, A, Bm, Cm, init_state):
    tensors = [x, dt, A, Bm, Cm] + ([init_state] if init_state is not None
                                    else [])
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape \
            or tuple(Bm.shape[:3]) != tuple(x.shape[:3]) \
            or tuple(dt.shape) != tuple(x.shape[:3]) \
            or tuple(A.shape) != (x.shape[2],):
        raise ValueError(f"ssd_chunk takes x (B, S, H, P), dt (B, S, H), A "
                         f"(H,), Bm and Cm (B, S, H, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B_, _, H, P = x.shape
    if init_state is not None and \
            tuple(init_state.shape) != (B_, H, P, Bm.shape[-1]):
        raise ValueError(f"ssd_chunk: init_state {tuple(init_state.shape)} "
                         f"is not (B, H, P, N)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd_chunk takes float32 tensors only, got "
                        f"{[t.dtype for t in tensors]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd_chunk has no backward kernel; differentiate through the "
            "plain SSD (use_pallas=False) or call it under torch.no_grad()")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
              init_state: torch.Tensor | None = None):
    """Chunked SSD → (y (B, S, H, P), final_state (B, H, P, N)), fp32."""
    _check(x, dt, A, Bm, Cm, init_state)
    Q = largest_divisor(x.shape[1], chunk)
    y_intra, states, decays = chunk_outputs(x, dt, A, Bm, Cm, Q)
    return ssd_combine(y_intra, states, decays, dt, A, Cm, init_state)


def chunk_outputs(x, dt, A, Bm, Cm, Q: int):
    """The kernel's part: (y_intra (B, S, H, P), states (B, S/Q, H, P, N),
    decays (B, S/Q, H)) for chunks of Q positions (Q divides S)."""
    _check(x, dt, A, Bm, Cm, None)
    if all(t.device.type == "cpu" for t in (x, dt, A, Bm, Cm)):
        return ssd_chunk_ref(x, dt, A, Bm, Cm, Q)

    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd_chunk: x, dt, A, Bm and Cm must all be on one "
                         "CUDA device")
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % Q or not 0 < Q <= MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd_chunk kernel takes a chunk Q ≤ {MAX_CHUNK} "
                         f"dividing S, P ≤ {MAX_HEAD_DIM} and N ≤ "
                         f"{MAX_STATE}; got S {S}, Q {Q}, P {P}, N {N}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)) or not A.is_contiguous():
        raise ValueError("ssd_chunk takes x, Bm and Cm with a unit-stride "
                         "last dim and a contiguous A")
    nC = S // Q
    if B_ * nC * H >= 2 ** 31:
        raise ValueError("ssd_chunk launches a block per (b, chunk, head): "
                         "fewer than 2^31")
    y = torch.empty((B_, S, H, P), dtype=torch.float32, device=dev)
    states = torch.empty((B_, nC, H, P, N), dtype=torch.float32, device=dev)
    decays = torch.empty((B_, nC, H), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, states, decays
    bimg, aux = _scratch(x, Bm, Q)
    # x rows copied in 16-byte pieces where every row start is aligned
    vec = P % 4 == 0 and x.data_ptr() % 16 == 0 and all(
        st % 4 == 0 for st in x.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_fns()[0](x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                              states.data_ptr(), decays.data_ptr(),
                              bimg.data_ptr(), aux.data_ptr(), B_, nC, Q, H,
                              P, N, _strides(x, dt, Bm, Cm), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {rc}")
    ssd_chunk.launches += 1
    return y, states, decays


def _strides(x, dt, Bm, Cm):
    return (ctypes.c_longlong * 12)(*(st for t in (x, dt, Bm, Cm)
                                      for st in t.stride()[:3]))


def _scratch(x, Bm, Q: int):
    """The kernel's scratch: B's and Bᵀ's tile images (hi and lo, per (b,
    chunk, group, tile); one group where B's head stride is 0, else one per
    head)
    and per (b, chunk, head) cum, dt and the state weights, padded to whole
    tiles."""
    B_, S, H, _ = x.shape
    nC, nJ = S // Q, -(-Q // TILE)
    groups = 1 if Bm.stride(2) == 0 else H
    bimg = torch.empty((B_ * nC * groups * nJ, TILE_IMAGES),
                       dtype=torch.float32, device=x.device)
    aux = torch.empty((B_ * nC * H, 3, nJ * TILE), dtype=torch.float32,
                      device=x.device)
    return bimg, aux


def operand_prep(x, dt, A, Bm, Cm, Q: int):
    """The kernel's prep pass alone (B's tile images, cum, dt and weights)
    into fresh scratch, on a CUDA tensor: for timing it apart."""
    B_, S, H, _ = x.shape
    bimg, aux = _scratch(x, Bm, Q)
    with torch.cuda.device(x.device):
        rc = _kernel_fns()[1](dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                              bimg.data_ptr(), aux.data_ptr(), B_, S // Q, Q,
                              H, Bm.shape[-1], _strides(x, dt, Bm, Cm),
                              torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk prep launch failed: CUDA error {rc}")
    return bimg, aux


ssd_chunk.launches = 0   # kernel launches since the caller last reset it
