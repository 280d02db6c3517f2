"""Empirical parametrization (paper §4.4), the p = 1 part; the port's
counterpart of ``repro.core.calibration``.

Measured ingredients feed the oracle:
  * compute: a serial forward and backward of the model (no optimizer, as
    the reference's ``value_and_grad``) → the processing element's effective
    FLOP/s, apportioned over the layers by FLOPs (every Table-3 row only
    uses sums or maxima over balanced groups, so that is equivalent);
  * on a CUDA card, its HBM rate (``measure_hbm_bw``) and its memory, which
    ``hardware.cuda_device_model`` holds.

The interconnect measurements of the reference (``measure_collective``,
``measure_alpha_beta``, contention, overlap and ``calibrate_cluster``) need
more than one rank and come with the parallel slice.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import replace

import torch

from .hardware import SystemModel, cpu_host_model, cuda_device_model


def time_fn(fn, *args, device: torch.device | str, iters: int = 5,
            warmup: int = 2) -> float:
    """Median seconds of one ``fn(*args)`` after ``warmup`` calls.

    On a CUDA device each call is timed by two CUDA events recorded on the
    current stream just before and just after it, so the time is the
    device's, from the start of the call's work to its end, whatever the
    host does meanwhile; the events are read once every call has been
    recorded. On the CPU each call is timed by ``perf_counter``."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            pairs = []
            for _ in range(iters):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                fn(*args)
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs) / 1e3
    if dev.type != "cpu":
        raise ValueError(f"time_fn times on 'cuda' or 'cpu', not {dev}")
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# the copy ``measure_hbm_bw`` times: 1 GiB, far past the card's L2 cache
HBM_PROBE_BYTES = 1 << 30


def measure_hbm_bw(device: torch.device | str) -> float:
    """Bytes per second of a device-to-device copy of HBM_PROBE_BYTES on a
    CUDA device: each copy reads and writes the buffer once, twice its
    size moved."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_hbm_bw times a CUDA device's memory, "
                         f"not {dev}")
    src = torch.ones(HBM_PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    t = time_fn(dst.copy_, src, device=dev, iters=10)
    del src, dst
    return 2.0 * HBM_PROBE_BYTES / t


def _device_of(params) -> torch.device:
    devices = {p.device for p in params}
    if len(devices) != 1:
        raise ValueError(f"the parameters lie on {sorted(map(str, devices))}; "
                         f"calibrate one device at a time")
    return devices.pop()


def calibrate_compute(loss_fn, params, batch, flops_per_step: float,
                      base: SystemModel | None = None) -> SystemModel:
    """Time a serial forward and backward and back out the effective rate.

    ``loss_fn(batch)`` returns ``(loss, aux)``; ``params`` are the tensors
    it is differentiated in (``torch.autograd.grad``, no update). With fwd +
    bwd ≈ 3× the forward's ``flops_per_step``, the rate is
    3·flops_per_step / t at efficiency 1 on ``base`` (``cpu_host_model()``
    unless given)."""
    params = list(params)
    dev = _device_of(params)

    def step(b):
        loss = loss_fn(b)[0]
        return torch.autograd.grad(loss, params)

    t = time_fn(step, batch, device=dev)
    base = base or cpu_host_model()
    eff_flops = flops_per_step * 3.0 / t  # fwd+bwd ≈ 3× fwd flops
    return replace(base, peak_flops=eff_flops, compute_efficiency=1.0)


def calibrate_host_system(loss_fn, params, batch,
                          flops_per_step: float) -> SystemModel:
    """The processing element the parameters lie on, calibrated: on a CUDA
    card ``cuda_device_model`` with its measured HBM rate, on the CPU
    ``cpu_host_model``; then ``calibrate_compute`` sets its FLOP/s."""
    params = list(params)
    dev = _device_of(params)
    base = None
    if dev.type == "cuda":
        # flops 0 until calibrate_compute sets the measured rate
        base = cuda_device_model(dev, hbm_bw=measure_hbm_bw(dev), flops=0.0)
    return calibrate_compute(loss_fn, params, batch, flops_per_step,
                             base=base)
