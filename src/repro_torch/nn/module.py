"""Execution context and parameter init (counterpart of ``repro.nn.module``).

The JAX package declares parameters as ``ParamSpec`` trees and initialises
each from a key folded with its tree path; PyTorch modules own their
parameters, so the port keeps only what a single-device run needs:

* ``ShardingCtx`` carries the device and ``use_pallas`` (which routes the CNN
  convs, the LM's RMSNorms and its prompt-pass attention through the
  hand-written kernels). Mesh, rules and ``constrain`` come with the
  parallel slice.
* ``fan_in_normal`` draws LeCun-normal weights over the same fan axes as
  ``fan_in_init``, from a ``torch.Generator``, where the generator lives.
  JAX's path-keyed draws cannot be reproduced, so parity tests carry JAX's
  weights over (``bridge.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device to run on; ``cuda`` unless the caller asks for the CPU.

    There is no fallback: asking for CUDA where it is absent raises. On CUDA,
    fp32 stays fp32 as in the reference: cuDNN's TF32 convolutions (on by
    default) and TF32 matmuls are switched off for the process."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@dataclass(frozen=True)
class ShardingCtx:
    """Device + ``use_pallas`` (the name the JAX package gives the switch that
    sends every 2-D ``HaloConv`` through the implicit-GEMM kernel; in the
    port it also sends ``RMSNorm`` and ``Attention.forward`` through
    theirs)."""

    device: torch.device | str = "cuda"
    use_pallas: bool = False

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))


def fan_in_normal(shape: Sequence[int], fan_axes: Sequence[int],
                  generator: torch.Generator | None, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.nn.Parameter:
    """LeCun normal: N(0, 1/fan_in), fan_in = prod(shape[a] for a in fan_axes).

    Drawn in ``dtype`` on the generator's device, then moved to ``device``:
    a CPU generator gives the same weights on every device, one on the
    target device draws a large model where it lives, with no host copy.
    On the ``meta`` device (shapes only) nothing is drawn and ``generator``
    may be None."""
    fan = int(np.prod([shape[a] for a in fan_axes]))
    w = torch.empty(tuple(shape), dtype=dtype,
                    device=device if generator is None else generator.device)
    if w.device.type != "meta":
        w.normal_(0.0, 1.0 / np.sqrt(max(fan, 1)), generator=generator)
    return torch.nn.Parameter(w.to(device))


def constant(shape: Sequence[int], value: float, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.full(tuple(shape), value, dtype=dtype,
                                         device=device))


def zeros_like_spec(spec, device: torch.device | str):
    """Zeros of every meta tensor's shape and dtype in a nested dict/list
    spec (``TransformerLM.cache_spec``), on ``device``."""
    if isinstance(spec, dict):
        return {k: zeros_like_spec(v, device) for k, v in spec.items()}
    if isinstance(spec, list):
        return [zeros_like_spec(v, device) for v in spec]
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
