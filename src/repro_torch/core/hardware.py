"""System models for the oracle (paper §4.2–4.4); the port's copy of
``repro.core.hardware``.

The paper parametrizes a cluster by Hockney α–β per interconnect level plus
per-PE compute throughput. The named presets (the paper's V100 cluster, the
JAX package's TPU pod, the CPU host) are kept as data, bit-identical to the
reference's, so projections agree between the packages; none of them is a
measurement of this port's hardware. ``cuda_device_model`` describes one
NVIDIA card from what ``core/calibration.py`` measures on it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Level:
    """One interconnect level with Hockney parameters."""

    name: str
    alpha: float          # startup seconds per message
    beta: float           # seconds per byte (1 / bandwidth)

    def p2p(self, nbytes: float, phi: float = 1.0) -> float:
        return self.alpha + nbytes * self.beta * phi

    def allreduce_ring(self, p: int, nbytes: float, phi: float = 1.0) -> float:
        """T_ar = 2(p−1)(α + (m/p)·δβ·φ) — paper §4.3."""
        if p <= 1:
            return 0.0
        return 2 * (p - 1) * (self.alpha + nbytes / p * self.beta * phi)

    def allgather_ring(self, p: int, nbytes: float, phi: float = 1.0) -> float:
        """T_ag = (p−1)(α + (m/p)·δβ·φ); m = full gathered size."""
        if p <= 1:
            return 0.0
        return (p - 1) * (self.alpha + nbytes / p * self.beta * phi)

    def reduce_scatter_ring(self, p: int, nbytes: float, phi: float = 1.0) -> float:
        if p <= 1:
            return 0.0
        return (p - 1) * (self.alpha + nbytes / p * self.beta * phi)

    def alltoall(self, p: int, nbytes: float, phi: float = 1.0) -> float:
        if p <= 1:
            return 0.0
        return (p - 1) * (self.alpha + nbytes / p * self.beta * phi)

    def allreduce_tree(self, p: int, nbytes: float, k: int = 4,
                       phi: float = 1.0) -> float:
        """Small-message tree: 2(log p + k)(α + m/2k·β) — paper footnote 4."""
        import math
        if p <= 1:
            return 0.0
        return 2 * (math.log2(p) + k) * (self.alpha + nbytes / (2 * k) * self.beta * phi)

    def allreduce(self, p: int, nbytes: float, phi: float = 1.0) -> float:
        """Ring for large messages, tree for small (NCCL/ICI practice)."""
        if nbytes < 65536:
            return min(self.allreduce_tree(p, nbytes, phi=phi),
                       self.allreduce_ring(p, nbytes, phi))
        return self.allreduce_ring(p, nbytes, phi)

    # -- vectorized variants (oracle sweep engine; p/nbytes may be arrays) --

    def allreduce_v(self, p, nbytes, phi: float = 1.0, k: int = 4):
        """``allreduce`` over numpy arrays of (p, nbytes); broadcasts."""
        p = np.asarray(p, np.float64)
        m = np.asarray(nbytes, np.float64)
        safe_p = np.where(p > 0, p, 1.0)
        ring = 2.0 * (p - 1) * (self.alpha + m / safe_p * self.beta * phi)
        tree = 2.0 * (np.log2(np.where(p > 1, p, 2.0)) + k) * (
            self.alpha + m / (2 * k) * self.beta * phi)
        out = np.where(m < 65536, np.minimum(tree, ring), ring)
        return np.where(p <= 1, 0.0, out)


@dataclass(frozen=True)
class SystemModel:
    """A machine: per-PE compute + interconnect levels keyed by mesh axis."""

    name: str
    peak_flops: float               # per-PE peak (or calibrated) FLOP/s
    hbm_bw: float                   # per-PE memory bandwidth
    mem_capacity: float             # per-PE memory bytes
    compute_efficiency: float       # fraction of peak for dense matmul
    levels: tuple                   # ((axis_name, Level), ...)

    def level(self, axis: str) -> Level:
        for name, lvl in self.levels:
            if name == axis:
                return lvl
        # default to the slowest level
        return self.levels[-1][1]

    def flops_time(self, flops: float) -> float:
        return flops / (self.peak_flops * self.compute_efficiency)


# The JAX package's TPU v5e pod preset (ICI axes intra-pod, DCI across
# pods), copied as data so the "tpu" preset projects as it does there.
TPU_V5E_POD = SystemModel(
    name="tpu-v5e-256",
    peak_flops=197e12, hbm_bw=819e9, mem_capacity=16e9,
    compute_efficiency=0.55,
    levels=(
        ("model", Level("ici-x", alpha=1e-6, beta=1 / 45e9)),
        ("data", Level("ici-y", alpha=1e-6, beta=1 / 45e9)),
        ("pod", Level("dci", alpha=10e-6, beta=1 / 25e9)),
    ))

# The paper's own system (ABCI-like: V100s, NVLink intra-node, IB inter-node)
PAPER_V100_CLUSTER = SystemModel(
    name="v100-abci",
    peak_flops=125e12, hbm_bw=900e9, mem_capacity=16e9,
    compute_efficiency=0.35,
    levels=(
        ("model", Level("nvlink", alpha=5e-6, beta=1 / 20e9)),
        ("data", Level("ib-edr", alpha=15e-6, beta=1 / 12.5e9)),
        ("pod", Level("ib-rack", alpha=25e-6, beta=1 / 4.2e9)),
    ))


def cpu_host_model(alpha: float = 3e-5, beta: float = 1 / 8e9,
                   flops: float = 5e10, efficiency: float = 1.0) -> SystemModel:
    """The measured-validation target: virtual host devices on this CPU.

    Defaults are placeholders — core/calibration.py measures the real values
    (paper §4.4 empirical parametrization).
    """
    lvl = Level("shm", alpha=alpha, beta=beta)
    return SystemModel(
        name="cpu-host", peak_flops=flops, hbm_bw=30e9, mem_capacity=8e9,
        compute_efficiency=efficiency,
        levels=(("model", lvl), ("data", lvl), ("pod", lvl)))


def cuda_device_model(device: torch.device | str, *, hbm_bw: float,
                      flops: float) -> SystemModel:
    """One NVIDIA card as a processing element: the counterpart of
    ``cpu_host_model`` for the measured validation on the card.

    ``mem_capacity`` is the card's own (``total_memory``); ``hbm_bw`` (bytes
    per second) and ``flops`` come from measurements on the card
    (``calibration.measure_hbm_bw``, ``calibration.calibrate_compute``), so
    nothing here is a datasheet number. The interconnect levels are
    placeholders, ``cpu_host_model``'s: one card runs at p = 1, where the
    data allreduce, the only term of the "data" row that reads them, is
    0."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"cuda_device_model describes a CUDA device, "
                         f"not {dev}")
    props = torch.cuda.get_device_properties(dev)
    lvl = Level("placeholder", alpha=3e-5, beta=1 / 8e9)
    return SystemModel(
        name=f"cuda:{props.name}", peak_flops=flops, hbm_bw=hbm_bw,
        mem_capacity=float(props.total_memory), compute_efficiency=1.0,
        levels=(("model", lvl), ("data", lvl), ("pod", lvl)))
