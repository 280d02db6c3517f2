"""Empirical parametrization (paper §4.4); the port's counterpart of
``repro.core.calibration``.

Measured ingredients feed the oracle:
  * compute: a serial forward and backward of the model (no optimizer, as
    the reference's ``value_and_grad``) → the processing element's effective
    FLOP/s, apportioned over the layers by FLOPs (every Table-3 row only
    uses sums or maxima over balanced groups, so that is equivalent);
  * on a CUDA card, its HBM rate (``measure_hbm_bw``) and its memory, which
    ``hardware.cuda_device_model`` holds;
  * across ranks, per mesh axis of extent > 1 (``calibrate_cluster``):
    all-reduces and all-gathers at several message sizes (Hockney α/β),
    contention φ and overlap σ, over the port's mesh and transport
    (``launch.mesh``; under gloo a CUDA all-gather crosses host buffers, so
    its α/β include the staging). The raw observations are
    ``cluster.Measurement`` records that ``ClusterSpec.fitted_from`` fits.

Every rank runs each measurement and every rank returns the slowest rank's
time, so all ranks fit the same ClusterSpec. The compute rate across ranks
is measured on one rank while the others wait; ranks that timeshare one
device then divide it by p (``per_pe_compute``), as the reference divides
its virtual host devices' rate.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import replace

import torch

import torch.distributed as dist

from ..parallel import collectives as C
from .cluster import ClusterSpec, Measurement
from .hardware import Level, SystemModel, cpu_host_model, cuda_device_model


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


def calibrate_host_system(loss_fn, params, batch, flops_per_step: float,
                          mesh=None) -> SystemModel:
    """The processing element the parameters lie on, calibrated: on a CUDA
    card ``cuda_device_model`` with its measured HBM rate, on the CPU
    ``cpu_host_model``; then ``calibrate_compute`` sets its FLOP/s (on one
    rank of ``mesh``, given one). With a mesh of more than one rank, also
    α/β per mesh axis of extent > 1: the slower of the all-reduce and the
    all-gather fit (the reference's choice: host allgathers can be far
    slower than the ring model)."""
    params = list(params)
    dev = _device_of(params)
    base = None
    if dev.type == "cuda":
        # flops 0 until calibrate_compute sets the measured rate
        base = cuda_device_model(dev, hbm_bw=measure_hbm_bw(dev), flops=0.0)
    if mesh is None or mesh.size == 1:
        return calibrate_compute(loss_fn, params, batch, flops_per_step,
                                 base=base)
    rate = _compute_rate(mesh, loss_fn, params, batch, flops_per_step, base)
    sysm = replace(base or cpu_host_model(), peak_flops=rate,
                   compute_efficiency=1.0)
    levels = []
    for axis, extent in mesh.shape.items():
        if extent > 1:
            ar = measure_alpha_beta(mesh, axis, pattern="ar")
            ag = measure_alpha_beta(mesh, axis, pattern="ag")
            levels.append((axis, ar if ar.beta >= ag.beta else ag))
        else:
            levels.append((axis, sysm.level(axis)))
    return replace(sysm, levels=tuple(levels))


def _world(mesh):
    return mesh.group(tuple(mesh.shape))


def _slowest(t: float, mesh) -> float:
    """The largest of the ranks' ``t`` (every rank gets it)."""
    x = torch.tensor([t], dtype=torch.float64, device=mesh.host_device)
    return float(C.all_reduce_max(x, _world(mesh)))


def _compute_rate(mesh, loss_fn, params, batch, flops_per_step: float,
                  base: SystemModel | None) -> float:
    """``calibrate_compute``'s FLOP/s, measured on rank 0 while the others
    wait at the all-reduce that hands it to every rank."""
    rate = 0.0
    if mesh.rank == 0:
        rate = calibrate_compute(loss_fn, params, batch, flops_per_step,
                                 base=base).peak_flops
    x = torch.tensor([rate], dtype=torch.float64, device=mesh.host_device)
    return float(C.all_reduce_max(x, _world(mesh)))


def measure_collective(mesh, axis: str = "data",
                       sizes=(1 << 12, 1 << 16, 1 << 20, 1 << 23),
                       pattern: str = "ar") -> Measurement:
    """Time one collective over ``axis`` at several message sizes, ``nbytes``
    of fp32 on each rank ("ar": all-reduced; "ag": all-gathered, p·nbytes
    out), as the reference's shapes; the raw observations (not a fit) —
    ``ClusterSpec.fitted_from`` recovers α/β."""
    g = mesh.group(axis)
    ts = []
    for nbytes in sizes:
        x = torch.zeros(nbytes // 4, dtype=torch.float32, device=mesh.device)
        if pattern == "ar":
            fn = lambda: C.all_reduce_sum(x, g)      # noqa: E731
        elif pattern == "ag":
            fn = lambda: C.gather_blocks(x, 0, g)    # noqa: E731
        else:
            raise ValueError(f"pattern {pattern!r}: 'ar' or 'ag'")
        ts.append(_slowest(time_fn(fn, device=mesh.device), mesh))
    return Measurement(level=axis, kind="collective", pattern=pattern,
                       p=g.size, nbytes=tuple(sizes), seconds=tuple(ts))


def measure_alpha_beta(mesh, axis: str = "data",
                       sizes=(1 << 12, 1 << 16, 1 << 20, 1 << 23),
                       pattern: str = "ar") -> Level:
    """Fit ring-model α/β over measured collectives.

    pattern "ar": T = 2(p−1)(α + m/p·β);  "ag": T = (p−1)(α + m/p·β).
    (One ``measure_collective`` run through the shared Hockney fit in
    cluster.py.)"""
    m = measure_collective(mesh, axis, sizes, pattern)
    lvl = ClusterSpec.fitted_from([m], base=cpu_host_model()).level(axis)
    return Level(f"measured-{axis}-{pattern}", alpha=lvl.alpha, beta=lvl.beta)


def _all_reduce_async(xs, group):
    works = [dist.all_reduce(x, group=group.pg, async_op=True) for x in xs]
    for w in works:
        w.wait()


def measure_contention(mesh, axis: str = "data", nbytes: int = 1 << 20,
                       flows: int = 2) -> Measurement:
    """Self-contention φ (paper §4.3): one saturating all-reduce alone vs
    ``flows`` independent ones issued together — sharing the level's
    links. φ = wall(shared) / wall(alone), clamped to [1, flows] by the fit
    (1 = perfectly concurrent, flows = serialized)."""
    g = mesh.group(axis)
    xs = [torch.zeros(nbytes // 4, dtype=torch.float32, device=mesh.device)
          for _ in range(flows)]
    alone = _slowest(time_fn(_all_reduce_async, xs[:1], g,
                             device=mesh.device), mesh)
    shared = _slowest(time_fn(_all_reduce_async, xs, g, device=mesh.device),
                      mesh)
    return Measurement(level=axis, kind="contention", alone_s=alone,
                       shared_s=shared, flows=flows)


def measure_overlap(mesh, axis: str = "data", nbytes: int = 1 << 21,
                    matmul_dim: int = 256, matmul_iters: int = 8
                    ) -> Measurement:
    """Overlap efficiency σ: independent compute (a chain of matmuls) and
    communication (an all-reduce) timed apart and together, the all-reduce
    issued first and waited on after the matmuls; whatever the runtime
    hides shows up as both < comp + comm. σ = (comp + comm − both) /
    min(comp, comm)."""
    g = mesh.group(axis)
    dev = mesh.device
    x = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    a = torch.full((matmul_dim, matmul_dim), 1e-3, device=dev)

    def comp():
        y = a
        for _ in range(matmul_iters):
            y = y @ a
        return y

    def both():
        work = dist.all_reduce(x, group=g.pg, async_op=True)
        y = comp()
        work.wait()
        return y

    t_comp = _slowest(time_fn(comp, device=dev), mesh)
    t_comm = _slowest(time_fn(_all_reduce_async, [x], g, device=dev), mesh)
    t_both = _slowest(time_fn(both, device=dev), mesh)
    return Measurement(level=axis, kind="overlap", comp_s=t_comp,
                       comm_s=t_comm, both_s=t_both)


def calibrate_cluster(mesh, *, base: ClusterSpec | None = None,
                      loss_fn=None, params=None, batch=None,
                      flops_per_step: float | None = None,
                      sizes=(1 << 12, 1 << 16, 1 << 20, 1 << 23),
                      per_pe_compute: bool = True
                      ) -> tuple[ClusterSpec, list]:
    """Run the measurement harness on a mesh and fit a ClusterSpec.

    Per mesh axis with extent > 1: α/β (all-reduce and all-gather
    patterns), contention φ, and overlap σ. With ``loss_fn``/``params``/
    ``batch``/``flops_per_step`` given, also calibrates compute (on rank 0;
    ``params`` those of a whole model); ranks that timeshare one device
    (``per_pe_compute``) divide the measured rate by the rank count.

    Returns ``(fitted ClusterSpec, raw measurements)``, the same on every
    rank. Without a mesh (one device) only the compute is calibrated: the
    base with its measured rate, and no measurements."""
    base = ClusterSpec.coerce(base) or ClusterSpec.of("host")
    if mesh is None:
        if loss_fn is not None:
            rate = calibrate_compute(loss_fn, params, batch, flops_per_step,
                                     base=base.system).peak_flops
            base = replace(base, peak_flops=rate, compute_efficiency=1.0)
        return base, []
    if loss_fn is not None:
        rate = _compute_rate(mesh, loss_fn, list(params), batch,
                             flops_per_step, base.system)
        if per_pe_compute:
            rate /= mesh.size
        base = replace(base, peak_flops=rate, compute_efficiency=1.0)
    ms: list[Measurement] = []
    for axis, extent in mesh.shape.items():
        if extent <= 1:
            continue
        ms.append(measure_collective(mesh, axis, sizes, "ar"))
        ms.append(measure_collective(mesh, axis, sizes, "ag"))
        ms.append(measure_contention(mesh, axis))
        ms.append(measure_overlap(mesh, axis))
    return ClusterSpec.fitted_from(ms, base=base), ms
