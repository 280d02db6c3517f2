#!/usr/bin/env python3
"""Where CosmoFlow's training step spends its time on one CUDA card, by the
memory layout its 3-D convolutions hand to cuDNN.

The port keeps activations channels-last (N, D, H, W, C), as the reference
does, and hands ``F.conv3d`` their channels-first *view*: to cuDNN that is
an NDHWC tensor (``torch.channels_last_3d``). This script runs, at
CosmoFlow's full config (128³ × 4 channels, batch 8, fp32, TF32 off, random
weights from seed 0, data from the port's seeded ``volume`` source):

  step   the SGD train step that the oracle's validation measures
         (``core.validation.measure_step``), with every 3-D conv input made
         NDHWC (``ndhwc``) or NCDHW-contiguous (``ncdhw``) just before
         ``F.conv3d``, in the order ndhwc, ncdhw, ncdhw, ndhwc;
  layer  each of the 5 convs alone at the shapes the step gives it:
         forward, input gradient (dgrad) and weight gradient (wgrad), each
         through ``aten.convolution_backward`` with input and output
         gradient in one layout or the other; ``copy_ms`` is the time of
         making the padded input NCDHW-contiguous, which the ``ncdhw`` step
         pays once a conv. conv0's dgrad is not part of the step (the
         images take no gradient).

Times are CUDA-event medians (``core.calibration.time_fn``). The card's
name and power limit are printed first.

    python3 scripts/cosmoflow_conv_layout.py

Needs a CUDA card; imports nothing of jax or of the JAX package.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.cnn_archs import ORACLE_BATCH  # noqa: E402
from repro_torch.core.calibration import time_fn  # noqa: E402
from repro_torch.core.validation import measure_step  # noqa: E402
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.kernels.util import conv_weight, same_pads  # noqa: E402
from repro_torch.launch.build import build_model  # noqa: E402
from repro_torch.launch.train import data_config_for  # noqa: E402
from repro_torch.nn import layers  # noqa: E402
from repro_torch.nn.module import ShardingCtx  # noqa: E402

LAYOUTS = {"ndhwc": torch.channels_last_3d, "ncdhw": torch.contiguous_format}


def conv3d_in(layout: str):
    """``F.conv3d`` with its input made ``layout`` first."""
    fmt = LAYOUTS[layout]

    def conv(x, w, **kw):
        return F.conv3d(x.contiguous(memory_format=fmt), w, **kw)
    return conv


def step_ms(model, batch, ctx, layout: str) -> float:
    layers._CONV[3] = conv3d_in(layout)
    try:
        return measure_step(model, batch, ctx) * 1e3
    finally:
        layers._CONV[3] = F.conv3d


def conv_inputs(model, images) -> list[torch.Tensor]:
    """The channels-last input of each 3-D conv in one forward."""
    seen = []
    hooks = [c.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
             for c in model.convs]
    with torch.no_grad():
        model(images, ShardingCtx(images.device))
    for h in hooks:
        h.remove()
    return seen


def layer_ms(x: torch.Tensor, w: torch.Tensor, dev) -> dict:
    """fwd, dgrad, wgrad of one SAME 3×3×3 conv in both layouts, and the
    copy that makes its padded input NCDHW."""
    pads = [same_pads(n, 3, 1) for n in x.shape[1:-1]]
    xc = layers._pad(layers._channels_first(x), pads)        # NDHWC view
    wv = conv_weight(w)
    y = F.conv3d(xc, wv)
    gy = torch.randn(y.shape, device=dev, generator=torch.Generator(
        dev).manual_seed(0)).contiguous(memory_format=torch.channels_last_3d)
    out = {"copy_ms": time_fn(lambda: xc.contiguous(), device=dev) * 1e3}
    for name, fmt in LAYOUTS.items():
        xl, gl = (t.contiguous(memory_format=fmt) for t in (xc, gy))

        def back(mask, xl=xl, gl=gl):
            return torch.ops.aten.convolution_backward(
                gl, xl, wv, None, [1] * 3, [0] * 3, [1] * 3, False, [0] * 3,
                1, mask)
        out[f"{name}_fwd_ms"] = time_fn(lambda xl=xl: F.conv3d(xl, wv),
                                        device=dev) * 1e3
        out[f"{name}_dgrad_ms"] = time_fn(back, [True, False, False],
                                          device=dev) * 1e3
        out[f"{name}_wgrad_ms"] = time_fn(back, [False, True, False],
                                          device=dev) * 1e3
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("cosmoflow_conv_layout: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    ctx = ShardingCtx(dev)                                  # TF32 off
    cfg = get_config("cosmoflow")
    batch_size = ORACLE_BATCH["cosmoflow"]
    model = build_model(cfg, ctx, seed=0)
    batch = Loader(data_config_for(cfg.model, batch_size), dev).batch_at(0)
    for layout in ("ndhwc", "ncdhw", "ncdhw", "ndhwc"):
        print(f"[step] cosmoflow batch={batch_size} layout={layout} "
              f"ms={step_ms(model, batch, ctx, layout):.6g}", flush=True)
    for i, (x, conv) in enumerate(zip(conv_inputs(model, batch["images"]),
                                      model.convs)):
        t = layer_ms(x, conv.w.detach(), dev)
        print(f"[layer] conv{i} in={tuple(x.shape)} out_ch={conv.w.shape[-1]} "
              + " ".join(f"{k}={v:.5g}" for k, v in t.items()), flush=True)


if __name__ == "__main__":
    main()
