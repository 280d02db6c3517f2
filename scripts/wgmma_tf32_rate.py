#!/usr/bin/env python3
"""The TF32 tensor-core rate of the wgmma shapes the port's 3xTF32 kernels
issue (``conv2d_gemm``, ``ssd_chunk``), on one CUDA card:

    python3 scripts/wgmma_tf32_rate.py

Builds ``scripts/wgmma_tf32_rate.cu`` with the kernels' nvcc flags into
``kernels/_build/`` and times one block per SM looping over a batch of
wgmmas (A in registers at n64 and n128, in batches of 12 or 48; A in shared
memory at n64), from one and from two warpgroups per SM. Prints TFLOP/s
against the 495 TFLOP/s TF32 peak (NVIDIA's data sheet, H100 SXM, 700 W)
and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

MODES = [(0, "A in registers, n64, batches of 12", 64, 12),
         (1, "A in registers, n64, batches of 48", 64, 48),
         (2, "A in registers, n128, batches of 12", 128, 12),
         (3, "A in shared memory, n64, batches of 12", 64, 12)]
ITERS = 2000


def main():
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_tf32_rate needs a CUDA card")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "libwgmma_tf32_rate.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "scripts" / "wgmma_tf32_rate.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).wgmma_tf32_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    print(smoke.nvidia_smi(), flush=True)
    for mode, name, n, batch in MODES:
        for warpgroups in (1, 2):
            fn(mode, out.data_ptr(), 10, warpgroups, sms)   # warm-up
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            rc = fn(mode, out.data_ptr(), ITERS, warpgroups, sms)
            end.record()
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"wgmma_tf32_rate mode {mode}: CUDA error "
                                 f"{rc}")
            ms = start.elapsed_time(end)
            flop = 2.0 * 64 * n * 8 * batch * ITERS * warpgroups * sms
            tflops = flop / (ms * 1e-3) / 1e12
            print(f"[rate] {name}, {warpgroups} warpgroup(s) per SM: "
                  f"{ms:.4f} ms, {tflops:.1f} TFLOP/s, "
                  f"{tflops / smoke.PEAK_TF32 * 1e12:.3f} of the TF32 peak",
                  flush=True)


if __name__ == "__main__":
    main()
