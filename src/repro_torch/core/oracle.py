"""ParaDL oracle: the paper's Table-3 analytical model, generalized (the
port's copy of ``repro.core.oracle``, numpy only).

Projects per-epoch (and per-iteration) computation time, communication time
and per-PE memory for each parallel strategy, from per-layer stats
(layer_stats.py) + a system model (hardware.py). Every formula carries its
paper provenance; rows marked *beyond-paper* extend the taxonomy (ZeRO,
expert parallelism, sequence-parallel residual streams) with the same α–β
methodology.

Compute times FW_l/BW_l/WU_l come from either
  * projection mode — FLOPs / (peak × efficiency)   (a system model's
    rates, measured or preset), or
  * calibrated mode — a measured per-layer table     (paper §4.4).

Structure (see DESIGN.md §1–§2): per-layer quantities are precomputed ONCE
into a dense ``StatTable`` (numpy arrays + the scalar reductions every
Table-3 row consumes), and the Table-3 math itself lives in a single
broadcast-capable evaluator ``_eval``. The per-point ``project()`` below is
a thin wrapper over ``_eval`` at one (strategy, p, p1, p2); the vectorized
sweep engine (sweep.py) calls the SAME evaluator with whole lattices of
points, so scalar and vectorized results agree to machine precision.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np

from .hardware import SystemModel
from .layer_stats import LayerStat
from .partition import cut_values, min_max_partition, stage_sums

STRATEGY_NAMES = ("serial", "data", "spatial", "pipeline", "filter", "channel",
                  "df", "ds", "ep", "summa")

# the pipeline strategy's schedule axis — must match the executor registry
# (parallel/schedules/runtime.SCHEDULE_NAMES; pinned by a unit test)
PIPELINE_SCHEDULES = ("gpipe", "one_f_one_b", "interleaved")

# layer kinds that expose a filter/channel split dimension (paper Table 2)
SPLIT_KINDS = ("conv", "fc", "attn", "ffn", "moe", "ssm", "rec")

# Default per-interconnect overlap efficiencies σ ∈ [0, 1] (DESIGN.md §10).
# The paper — like its Table 3 — charges every comm term serially; the
# executor does not: the halo exchange runs under the interior convolution
# (parallel/halo.py, after Dryden et al. — near-full hiding, σ ≈ 0.9) and
# the gradient allreduce pipelines under backward compute (σ ≈ 0.8, the
# standard DP bucketing overlap). ``OracleConfig.overlap=False`` restores
# the paper's serial accounting exactly (σ ≡ 0).
SIGMA_DEFAULTS = {"model": 0.9, "data": 0.8}


@dataclass(frozen=True)
class TimeModel:
    """Source of FW/BW/WU times (paper §4.4 empirical parametrization)."""

    system: SystemModel
    calibrated: dict | None = None     # name -> (fw_s, bw_s, wu_s) per sample
    wu_bytes_per_param: float = 16.0   # adam: m+v+p fp32 read/write amortized

    def fw(self, st: LayerStat) -> float:
        if self.calibrated and st.name in self.calibrated:
            return self.calibrated[st.name][0]
        return self.system.flops_time(st.flops_fwd)

    def bw(self, st: LayerStat) -> float:
        if self.calibrated and st.name in self.calibrated:
            return self.calibrated[st.name][1]
        return self.system.flops_time(st.flops_bwd)

    def wu(self, st: LayerStat) -> float:
        if self.calibrated and st.name in self.calibrated:
            return self.calibrated[st.name][2]
        return st.w * self.wu_bytes_per_param / self.system.hbm_bw


@dataclass
class Projection:
    """Oracle output for one (strategy, p) point. Times are PER EPOCH;
    ``per_iteration()`` divides by D/B."""

    strategy: str
    p: int
    p1: int                      # data-parallel groups (hybrids)
    p2: int                      # model-parallel width (hybrids)
    comp_s: float
    comm_ge_s: float             # gradient exchange (paper GE)
    comm_fb_s: float             # layer-wise collectives in FB (filter/channel)
    comm_halo_s: float           # spatial halo exchange
    comm_p2p_s: float            # pipeline stage-boundary traffic
    mem_bytes: float
    feasible: bool
    limit: str
    iterations: float
    phases: dict = field(default_factory=dict)
    p2r: int = 1                 # model-grid rows (summa; p2 = p2r·p2c)
    p2c: int = 1                 # model-grid cols (summa)

    @property
    def comm_s(self) -> float:
        return self.comm_ge_s + self.comm_fb_s + self.comm_halo_s + self.comm_p2p_s

    @property
    def total_s(self) -> float:
        return self.comp_s + self.comm_s

    def per_iteration(self) -> dict:
        it = max(self.iterations, 1.0)
        return {"comp_s": self.comp_s / it, "comm_s": self.comm_s / it,
                "total_s": self.total_s / it}


@dataclass(frozen=True)
class OracleConfig:
    B: int                        # global mini-batch (weak scaling: B = b·p)
    D: int                        # dataset samples per epoch
    delta: float = 2.0            # bytes per element (bf16)
    gamma: float = 0.6            # memory reuse factor (paper §4.2, [20,28])
    phi_hybrid: float = 2.0       # contention coefficient for df (paper §5.2)
    # optional per-interconnect φ table {"data": φ, "model": φ} (dict or
    # tuple of pairs) — calibrated values override the defaults: the hybrid
    # gradient exchange ("data") defaults to phi_hybrid, the model-level
    # FB/halo/P2P terms to 1.0. No term crosses the pod/DCI hop separately
    # yet, so a "pod" entry has nothing to scale (the CLI rejects it).
    phi_levels: "dict | tuple | None" = None
    # comm/compute overlap model (DESIGN.md §10). ``overlap=False``
    # reproduces the paper's serial accounting bit-for-bit; with it on, the
    # halo P2P hides under the halo layers' interior compute (model level)
    # and the gradient exchange under backward compute (data level), each
    # discounted by a per-interconnect efficiency σ — SIGMA_DEFAULTS unless
    # a calibrated ``sigma_levels`` table overrides them. FB collectives
    # (filter/channel allgathers) and pipeline stage P2P stay serial: their
    # consumers data-depend on the transfer.
    overlap: bool = True
    sigma_levels: "dict | tuple | None" = None
    segments: int = 8             # pipeline micro-batch segments S
    # pipeline schedule axis (DESIGN.md §4): which clocking the executor
    # runs — "gpipe" (fill/drain, S microbatches of activations live),
    # "one_f_one_b" (same clock, ≤p in flight) or "interleaved" (v virtual
    # stages per rank: bubble shrinks v×, stage-boundary traffic grows v×).
    schedule: str = "gpipe"
    virtual_stages: int = 2       # interleaved v (ignored by other schedules)
    zero1: bool = False           # shard WU across DP ranks ([52], §5.3.3)
    # beyond-paper memory-model extensions (DESIGN.md §3):
    remat: bool = False           # activation checkpointing: keep |x_l| only
    zero3: bool = False           # params sharded over DP too (ZeRO-3 / [38])
    seq_parallel: bool = False    # residual stream sharded over model axis
    opt_bytes_per_param: float = 8.0  # adam m+v fp32

    def phi_for(self, level: str, default: float = 1.0) -> float:
        """Contention coefficient for one interconnect level. With no
        ``phi_levels`` table the caller's default applies (phi_hybrid for
        the hybrid gradient exchange, 1.0 elsewhere) — current behavior."""
        t = self.phi_levels
        if t is None:
            return default
        items = t.items() if isinstance(t, dict) else t
        for k, v in items:
            if k == level:
                return float(v)
        return default

    def sigma_for(self, level: str) -> float:
        """Overlap efficiency for one interconnect level; 0 (fully serial,
        the paper's model) when ``overlap`` is off. Clamped to [0, 1]."""
        if not self.overlap:
            return 0.0
        t = self.sigma_levels
        if t is not None:
            items = t.items() if isinstance(t, dict) else t
            for k, v in items:
                if k == level:
                    return min(max(float(v), 0.0), 1.0)
        return SIGMA_DEFAULTS.get(level, 0.0)


# ---------------------------------------------------------------------------
# Precomputed per-layer tables (shared by project() and the sweep engine)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class StatTable:
    """Dense per-layer arrays + the scalar reductions the Table-3 formulas
    consume. Built once per (stats, TimeModel) pair; every quantity here is
    independent of (strategy, p, p1, p2, B)."""

    n: int                       # layer count G
    fw: np.ndarray               # per-layer forward seconds per sample
    bw: np.ndarray
    wu: np.ndarray               # per-layer weight-update seconds per iter
    x: np.ndarray                # |x_l| elements per sample
    y: np.ndarray
    w: np.ndarray                # |w_l| elements
    # scalar reductions
    FW: float
    BW: float
    WU: float
    W: float                     # total weight elements
    x_sum: float
    xy_sum: float                # Σ(|x_l| + |y_l|)
    y_head_sum: float            # Σ_{l < G-1} |y_l| (FB collectives skip last)
    y_max: float                 # pipeline stage-boundary bound
    n_halo: int
    halo_sum: float
    halo_fw_bw: float            # Σ_{l: halo>0} (fw_l + bw_l) — the interior
                                 # compute a spatial halo exchange hides under
    sp_min: int                  # min spatial extent over conv/attn layers
    any_recurrent: bool
    minF: int | None             # over SPLIT_KINDS layers; None = no such layer
    minC: int | None
    n_moe: int
    moe_y_sum: float
    moe_minF: int | None         # experts bound for ep


_TABLES: dict = {}


def _tm_key(tm: TimeModel):
    cal = tuple(sorted(tm.calibrated.items())) if tm.calibrated else None
    return (tm.system, tm.wu_bytes_per_param, cal)


def precompute(stats: list[LayerStat], tm: TimeModel) -> StatTable:
    """Memoized dense-array build; key is pure content (stats are frozen)."""
    key = (tuple(stats), _tm_key(tm))
    tbl = _TABLES.get(key)
    if tbl is None:
        if len(_TABLES) > 64:
            _TABLES.clear()
        tbl = _build_table(stats, tm)
        _TABLES[key] = tbl
    return tbl


def _build_table(stats, tm: TimeModel) -> StatTable:
    fw = np.array([tm.fw(s) for s in stats], np.float64)
    bw = np.array([tm.bw(s) for s in stats], np.float64)
    wu = np.array([tm.wu(s) for s in stats], np.float64)
    x = np.array([s.x for s in stats], np.float64)
    y = np.array([s.y for s in stats], np.float64)
    w = np.array([s.w for s in stats], np.float64)
    halo = np.array([s.halo for s in stats], np.float64)
    F = np.array([s.F for s in stats], np.int64)
    C = np.array([s.C for s in stats], np.int64)
    spatial = np.array([s.spatial for s in stats], np.int64)
    split = np.array([s.kind in SPLIT_KINDS for s in stats], bool)
    conv_attn = np.array([s.kind in ("conv", "attn") for s in stats], bool)
    moe = np.array([s.kind == "moe" for s in stats], bool)
    rec = np.array([s.seq_recurrent for s in stats], bool)
    hm = halo > 0
    sp_cand = spatial[conv_attn & (spatial > 1)]
    return StatTable(
        n=len(stats), fw=fw, bw=bw, wu=wu, x=x, y=y, w=w,
        FW=float(np.sum(fw)), BW=float(np.sum(bw)), WU=float(np.sum(wu)),
        W=float(np.sum(w)), x_sum=float(np.sum(x)),
        xy_sum=float(np.sum(x + y)), y_head_sum=float(np.sum(y[:-1])),
        y_max=float(y.max()) if len(y) else 0.0,
        n_halo=int(hm.sum()), halo_sum=float(halo[hm].sum()),
        halo_fw_bw=float((fw[hm] + bw[hm]).sum()),
        sp_min=int(sp_cand.min()) if sp_cand.size else 1,
        any_recurrent=bool(rec.any()),
        minF=int(F[split].min()) if split.any() else None,
        minC=int(C[split].min()) if split.any() else None,
        n_moe=int(moe.sum()), moe_y_sum=float(y[moe].sum()),
        moe_minF=int(F[moe].min()) if moe.any() else None)


# ---------------------------------------------------------------------------
# Pipeline stage partitions (non-uniform stages; paper §5.3.3 caveat closed)
# ---------------------------------------------------------------------------

# StatTable → {k: (max ΣFW, max ΣBW, max ΣWU, max cut |y|, max Σ(x+y), max Σw)}
_STAGE_TERMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def pipeline_stage_terms(T: StatTable, k: int) -> tuple:
    """Bottleneck-stage quantities for the optimal contiguous partition of
    T's layers into k stages (DP over per-layer fw+bw, core/partition.py).

    Returns (max stage ΣFW, max stage ΣBW, max stage ΣWU, max boundary |y|,
    max stage Σ(|x|+|y|), max stage Σ|w|). The cut minimizes the fw+bw
    bottleneck — the schedule's pacing term; memory/WU maxima are reported
    at those same cuts (one partition deploys, so one partition is modeled).
    """
    k = int(min(max(k, 1), T.n))
    cache = _STAGE_TERMS.setdefault(T, {})
    hit = cache.get(k)
    if hit is None:
        part = min_max_partition(T.fw + T.bw, k)
        b = part.bounds
        cuts = cut_values(T.y, b)
        hit = (float(stage_sums(T.fw, b).max()),
               float(stage_sums(T.bw, b).max()),
               float(stage_sums(T.wu, b).max()),
               float(cuts.max()) if cuts.size else 0.0,
               float(stage_sums(T.x + T.y, b).max()),
               float(stage_sums(T.w, b).max()))
        cache[k] = hit
    return hit


def _pipeline_terms_bcast(T: StatTable, p, shape) -> tuple:
    """``pipeline_stage_terms`` over a (possibly scalar) lattice of p values,
    broadcast to ``shape``; p is clamped into [1, G] (points outside are
    scale-infeasible anyway, but every lattice row needs defined numbers)."""
    pk = np.clip(np.broadcast_to(np.asarray(p, np.int64), shape), 1, T.n)
    terms = np.array([pipeline_stage_terms(T, int(v)) for v in np.ravel(pk)],
                     np.float64)
    return tuple(terms[:, j].reshape(shape) for j in range(terms.shape[1]))


# ---------------------------------------------------------------------------
# The Table-3 math, once, broadcast-capable
# ---------------------------------------------------------------------------

def _balanced_divisor(n: int) -> int:
    """Largest divisor of n that is ≤ √n — the row extent of the most
    balanced (r, c) grid with r·c = n and r ≤ c."""
    n = int(n)
    r = 1
    for d in range(1, int(n ** 0.5) + 1):
        if n % d == 0:
            r = d
    return r


def _summa_row_level(sysm: SystemModel):
    """Interconnect level pricing the SUMMA row dimension (weight-panel
    ring). A machine description may expose a distinct second model hop as
    a "model2" level (ClusterSpec 2D grids); absent that, both grid dims
    ride the model interconnect. NOTE: ``SystemModel.level`` falls back to
    the LAST (slowest) level for unknown names, so the scan here must be
    explicit — a blind ``level("model2")`` would price the row ring at
    pod/DCI speed."""
    for name, lvl in sysm.levels:
        if name == "model2":
            return lvl
    return sysm.level("model")


def _eval_row(T: StatTable, strategy: str, cfg: OracleConfig,
              sysm: SystemModel, p, p1, p2, p2_eff, B,
              p2r=None, p2c=None) -> dict:
    """Evaluate one strategy's Table-3 row at (p, p1, p2, B).

    Every argument may be a python scalar (per-point ``project()``) or a
    numpy array of lattice points (sweep engine); all arithmetic broadcasts.
    ``p2r``/``p2c`` factor the model width into a (row × col) grid — only
    the "summa" row reads them. Returns per-epoch seconds/bytes arrays:
    comp, ge, fb, halo, p2p, mem, feasible, iters.
    """
    delta, gamma = cfg.delta, cfg.gamma
    D = cfg.D
    p = np.asarray(p, np.float64)
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    p2_eff = np.asarray(p2_eff, np.float64)
    B = np.asarray(B, np.float64)
    shape = np.broadcast(p, p1, p2, B).shape
    zeros = np.zeros(shape)
    iters = D / B
    lvl_model = sysm.level("model")
    lvl_data = sysm.level("data")
    FW, BW, WU = T.FW, T.BW, T.WU
    Wbytes = T.W * delta

    def mem(act_div=1.0, w_div=1.0, dp=1.0):
        """Per-PE memory. Paper Table-3 expression, extended with remat/
        ZeRO-3/seq-parallel switches and optimizer state (DESIGN.md §3)."""
        act = B * (T.x_sum if cfg.remat else 2.0 * T.xy_sum) / act_div
        if cfg.seq_parallel:
            act = np.where(p2_eff > 1, act / p2_eff, act)
        wdiv = w_div * (dp if cfg.zero3 else 1.0)
        wmem = 2.0 * T.W / wdiv * delta              # params + grads
        opt = T.W * cfg.opt_bytes_per_param / (
            w_div * (dp if (cfg.zero1 or cfg.zero3) else 1.0))
        return gamma * delta * act + wmem + opt

    # per-level contention: the hybrid gradient exchange defaults to the
    # paper's φ constant, model-level collectives to 1.0; a calibrated
    # cfg.phi_levels table overrides either (ROADMAP φ-calibration item)
    phi_ge = cfg.phi_for("data", cfg.phi_hybrid)
    phi_m = cfg.phi_for("model", 1.0)

    # comm/compute overlap (DESIGN.md §10): a comm term T with a concurrent
    # compute window W is charged at its EXPOSED cost T − σ·min(W, T), i.e.
    # the step pays max(W', φT) + (1−σ)·min(W', φT) instead of W' + φT over
    # the window. σ = 0 (overlap off) restores the paper's serial sum
    # exactly. The halo exchange hides under the halo layers' interior
    # fw+bw (the overlapped executor, parallel/halo.py); the gradient
    # exchange hides under backward compute (DP bucketing).
    sig_m = cfg.sigma_for("model")
    sig_d = cfg.sigma_for("data")

    def exposed(comm, window, sigma):
        return comm - sigma * np.minimum(window, comm)

    def halo_and_ge(halo_full, ge_full, bw_epoch):
        """Exposed (halo, ge) for the spatial strategies. The halo hides
        under the halo layers' fw+bw; the gradient exchange under backward
        compute — but the halo layers' bw is a subset of BW, so the GE
        window must exclude the compute seconds the halo already consumed
        (one second of backward hides one second of comm, once)."""
        win_halo = D / p * T.halo_fw_bw
        halo_hidden = sig_m * np.minimum(win_halo, halo_full)
        win_ge = np.maximum(bw_epoch - halo_hidden, 0.0)
        return halo_full - halo_hidden, exposed(ge_full, win_ge, sig_d)

    def halo_term(batch):
        # Σ_{l: halo>0} 2·(2α + 2·batch·halo_l·δ·β·φ), closed form
        return iters * (4.0 * lvl_model.alpha * T.n_halo
                        + 4.0 * batch * delta * lvl_model.beta * phi_m
                        * T.halo_sum)

    def fb_term(width):
        # Σ_{l < G-1} 3·(width−1)·(α + B·y_l·δ/p·β·φ), closed form
        return 3.0 * iters * (width - 1) * (
            lvl_model.alpha * (T.n - 1)
            + B * delta * lvl_model.beta * phi_m / p * T.y_head_sum)

    out = dict(comp=zeros, ge=zeros, fb=zeros, halo=zeros, p2p=zeros,
               mem=zeros, feasible=np.ones(shape, bool), iters=iters + zeros)

    if strategy == "serial":
        out["comp"] = (D * (FW + BW) + iters * WU) + zeros
        out["mem"] = mem() + zeros
        return out

    if strategy == "data":
        out["feasible"] = p <= B
        out["comp"] = D / p * (FW + BW) + iters * (WU / p if cfg.zero1 else WU)
        out["ge"] = exposed(iters * lvl_data.allreduce_v(p, Wbytes),
                            D / p * BW, sig_d)
        out["mem"] = mem(act_div=p, dp=p) + zeros
        return out

    if strategy == "spatial":
        out["feasible"] = (p <= T.sp_min) & (not T.any_recurrent)
        out["comp"] = D / p * (FW + BW) + iters * WU
        out["halo"], out["ge"] = halo_and_ge(
            halo_term(B), iters * lvl_data.allreduce_v(p, Wbytes),
            D / p * BW)
        out["mem"] = mem(act_div=p) + zeros
        return out

    if strategy == "pipeline":
        S = cfg.segments
        sched = cfg.schedule
        # non-uniform stages: the DP partitioner (core/partition.py) cuts
        # layers minimizing the bottleneck stage, and the schedule is paced
        # by max FW_Gi + max BW_Gi — not the balanced total/p the paper's
        # §5.3.3 caveat assumed. Boundary traffic uses the activation sizes
        # at the ACTUAL cut points, not the global max layer output.
        mfw, mbw, mwu, ycut, mxy, mw = _pipeline_terms_bcast(T, p, shape)
        if sched in ("gpipe", "one_f_one_b"):
            # identical clock (1F1B's forward schedule IS GPipe's; its
            # backward reordering changes memory, not the critical path):
            # (p+S−1) stage-ticks of the bottleneck stage, bubble (p−1)/S
            out["feasible"] = p <= T.n
            out["comp"] = D * (p + S - 1) / S * (mfw + mbw) + iters * mwu
            out["p2p"] = np.where(p > 1, 2 * D * (p + S - 2) / B * (
                lvl_model.alpha
                + B / S * ycut * delta * lvl_model.beta * phi_m), 0.0)
            # activation residency: GPipe holds all S microbatches'
            # activations between forward and backward; 1F1B's steady state
            # holds at most p (min(p/S, 1) of the batch's worth)
            act = (1.0 if sched == "gpipe"
                   else np.minimum(p / np.maximum(S, 1.0), 1.0))
            out["mem"] = gamma * delta * np.maximum(
                2.0 * B * act * mxy + 2.0 * mw, 1.0)
            return out
        if sched == "interleaved":
            v = max(int(cfg.virtual_stages), 1)
            out["feasible"] = v * p <= T.n
            # v·p chunks round-robin over p ranks: v·S + p − 1 chunk-ticks
            # at the bottleneck CHUNK cost (the v·p-way partition maxima) —
            # the fill/drain bubble shrinks to (p−1)/(v·S). Weight update
            # stays per-rank: a rank owns v chunks ≈ its p-cut stage's
            # layers, so mwu (the p-way partition max) is the right charge.
            cfw, cbw, _cwu, cycut, _cxy, _cw = _pipeline_terms_bcast(
                T, v * p, shape)
            out["comp"] = (D * (v * S + p - 1) / S * (cfw + cbw)
                           + iters * mwu)
            # v× the boundary hops, each shipping the cut activation of the
            # FINER v·p-way partition
            out["p2p"] = np.where(p > 1, 2 * D * (v * S + p - 2) / B * (
                lvl_model.alpha
                + B / S * cycut * delta * lvl_model.beta * phi_m), 0.0)
            # steady-state in-flight microbatches: p + v − 1 (each rank
            # holds one microbatch per virtual slot as groups overlap);
            # weights are the rank's full p-cut share (all v chunks)
            act = np.minimum((p + v - 1.0) / np.maximum(S, 1.0), 1.0)
            out["mem"] = gamma * delta * np.maximum(
                2.0 * B * act * mxy + 2.0 * mw, 1.0)
            return out
        raise ValueError(f"unknown pipeline schedule {sched!r}")

    if strategy in ("filter", "channel"):
        lim = T.minF if strategy == "filter" else T.minC
        if lim is None:
            raise ValueError(f"{strategy}: no splittable layers")
        out["feasible"] = p <= lim
        out["comp"] = D / p * (FW + BW) + iters * WU / p
        out["fb"] = fb_term(p)
        out["mem"] = mem(w_div=p) + zeros
        return out

    if strategy == "df":
        if T.minF is None:
            raise ValueError("df: no splittable layers")
        out["feasible"] = (p1 * p2 == p) & (p2 <= T.minF) & (p1 <= B)
        out["comp"] = D / p * (FW + BW) + iters * (
            WU / p if cfg.zero1 else WU / p2)
        out["fb"] = fb_term(p2)
        out["ge"] = exposed(
            iters * lvl_data.allreduce_v(p1, Wbytes / p2, phi=phi_ge),
            D / p * BW, sig_d)
        out["mem"] = mem(act_div=p1, w_div=p2, dp=p1) + zeros
        return out

    if strategy == "ds":
        out["feasible"] = ((p1 * p2 == p) & (p2 <= T.sp_min) & (p1 <= B)
                           & (not T.any_recurrent))
        out["comp"] = D / p * (FW + BW) + iters * (
            WU / p if cfg.zero1 else WU)
        out["halo"], out["ge"] = halo_and_ge(
            halo_term(B / p1),
            iters * lvl_data.allreduce_v(p, Wbytes, phi=phi_ge),
            D / p * BW)
        out["mem"] = mem(act_div=p, dp=p1) + zeros
        return out

    if strategy == "ep":  # beyond-paper: expert parallelism for MoE
        if T.n_moe == 0:
            out["feasible"] = np.zeros(shape, bool)
            return out
        out["feasible"] = (p2 <= T.moe_minF) & (p1 <= B)
        out["comp"] = D / p * (FW + BW) + iters * WU / p
        # two all-to-alls per MoE layer per direction (dispatch + combine):
        # Σ_moe 4·alltoall(p2, B·y_l·δ/p1), closed form
        out["fb"] = np.where(p2 > 1, 4.0 * iters * (p2 - 1) * (
            lvl_model.alpha * T.n_moe
            + B * delta * lvl_model.beta / (p1 * p2) * T.moe_y_sum), 0.0)
        out["ge"] = exposed(
            iters * lvl_data.allreduce_v(p1, Wbytes / p2, phi=phi_ge),
            D / p * BW, sig_d)
        out["mem"] = mem(act_div=p1, w_div=p2, dp=p1) + zeros
        return out

    if strategy == "summa":  # beyond-paper: 2D (row × col) tensor grid
        if T.minF is None or T.minC is None:
            raise ValueError("summa: no splittable layers")
        r = np.asarray(1 if p2r is None else p2r, np.float64)
        c = np.asarray(1 if p2c is None else p2c, np.float64)
        out["feasible"] = ((p1 * p2 == p) & (r * c == p2)
                           & (c <= T.minF) & (r <= T.minC) & (p1 <= B))
        out["comp"] = D / p * (FW + BW) + iters * (
            WU / p if cfg.zero1 else WU / p2)
        # SUMMA per layer (parallel/summa.py): fw allgathers the activation
        # blocks along the COLUMN ring ((c−1) steps of B·y_l·δ/p each) and
        # circulates the weight panels along the ROW ring ((r−1) steps of
        # w_l·δ/p2 each); backward replays both for dgrad and wgrad — 3
        # passes total, the same 3× as the paper's filter/channel row. At
        # r = 1 this degenerates bit-for-bit to fb_term(p2) plus a zero row
        # term, i.e. the 1D filter split it contains.
        lvl_row = _summa_row_level(sysm)
        act = (lvl_model.alpha * (T.n - 1)
               + B * delta * lvl_model.beta * phi_m / p * T.y_head_sum)
        wgt = (lvl_row.alpha * (T.n - 1)
               + delta * lvl_row.beta * phi_m / np.maximum(p2, 1.0) * T.W)
        out["fb"] = 3.0 * iters * ((c - 1.0) * act + (r - 1.0) * wgt)
        out["ge"] = exposed(
            iters * lvl_data.allreduce_v(p1, Wbytes / p2, phi=phi_ge),
            D / p * BW, sig_d)
        # activations: batch over p1, sequence over r; the column shard of
        # the hidden dim is transient (the fw allgather rematerializes the
        # full hidden block), so the resident residual divides by p1·r only
        # — the seq_parallel switch (p2_eff = c) claims the rest.
        out["mem"] = mem(act_div=p1 * r, w_div=p2, dp=p1) + zeros
        return out

    raise ValueError(strategy)


def _eval(T: StatTable, strategy: str, cfg: OracleConfig, sysm: SystemModel,
          p, p1, p2, p2_eff, B, p2r=None, p2c=None) -> dict:
    """``_eval_row`` plus the cross-cutting sequence-parallel communication
    term (DESIGN.md §14).

    ``seq_parallel`` shards the residual stream over the model width
    p2_eff; that is not free: each sharded block allgathers the residual
    before consuming it and reduce-scatters it back after producing it
    (Korthikanti et al. — the collectives replace, not join, the identity
    pass-through). Per layer l (< G, the head keeps its own collective)
    that is one allgather + one reduce-scatter in forward and the mirrored
    pair in backward — 4 ring collectives of B·y_l·δ/p per step:

        4 · iters · (p2_eff−1) · (α_m·(G−1) + B·δ·β_m·φ_m/p · Σ y_l)

    overlap-discounted by σ(model) against the forward-compute window
    (the gather streams ahead of each block; backward's window is already
    claimed by the gradient exchange). With an ideal interconnect
    (α→0, bandwidth→∞ i.e. β→0) the term vanishes and the old memory-only
    switch behavior is recovered exactly (test_oracle_properties.py).
    """
    out = _eval_row(T, strategy, cfg, sysm, p, p1, p2, p2_eff, B,
                    p2r=p2r, p2c=p2c)
    # serial has no model axis; pipeline's projection is memory-switch-
    # invariant by design (its stage memory model ignores the switches, and
    # the executor deploys none — autotune.deployable_switch_mask)
    if not cfg.seq_parallel or strategy in ("serial", "pipeline"):
        return out
    p_ = np.asarray(p, np.float64)
    pe = np.asarray(p2_eff, np.float64)
    B_ = np.asarray(B, np.float64)
    iters = out["iters"]
    lvl_model = sysm.level("model")
    phi_m = cfg.phi_for("model", 1.0)
    full = np.where(pe > 1, 4.0 * iters * (pe - 1.0) * (
        lvl_model.alpha * (T.n - 1)
        + B_ * cfg.delta * lvl_model.beta * phi_m / p_ * T.y_head_sum), 0.0)
    window = cfg.D / p_ * T.FW
    sig_m = cfg.sigma_for("model")
    out["fb"] = out["fb"] + full - sig_m * np.minimum(window, full)
    return out


def _limit_str(strategy: str, T: StatTable, B, feasible: bool,
               cfg: "OracleConfig | None" = None) -> str:
    """Human-readable scaling-limit description (mirrors the paper's notes)."""
    if strategy == "serial":
        return "p = 1"
    if strategy == "data":
        return "p <= B" + ("" if feasible else f" violated (B={B})")
    if strategy == "spatial":
        return (f"p <= min spatial ({T.sp_min})"
                + ("" if feasible else " or recurrent-seq violated"))
    if strategy == "pipeline":
        if cfg is not None and cfg.schedule == "interleaved":
            return f"v*p <= G ({T.n}), v={max(int(cfg.virtual_stages), 1)}"
        return f"p <= G ({T.n})"
    if strategy in ("filter", "channel"):
        lim = T.minF if strategy == "filter" else T.minC
        return (f"p <= min {'F' if strategy == 'filter' else 'C'}_l ({lim})")
    if strategy == "df":
        return f"p = p1·p2 <= B·min F ({B}·{T.minF})"
    if strategy == "ds":
        return f"p2 <= min spatial ({T.sp_min}); recurrent-seq blocks"
    if strategy == "ep":
        return ("no MoE layers" if T.n_moe == 0
                else f"p2 <= n_experts ({T.moe_minF})")
    if strategy == "summa":
        return (f"p2 = p2r·p2c, p2r <= min C_l ({T.minC}), "
                f"p2c <= min F_l ({T.minF})")
    return ""


def project(strategy: str, stats: list[LayerStat], tm: TimeModel,
            cfg: OracleConfig, p: int, p1: int | None = None,
            p2: int | None = None, p2r: int | None = None,
            p2c: int | None = None) -> Projection:
    """One Table-3 row evaluated at p PEs (thin wrapper over ``_eval``).

    For "summa" the model width additionally factors into a (p2r × p2c)
    grid; unspecified grid dims default to the most balanced factorization
    of p2 (r ≤ c — columns shard the wider hidden/filter dimension)."""
    T = precompute(stats, tm)
    # p2_eff is derived from the CALLER's p2 (before hybrid defaulting), as
    # the seq-parallel memory switch keys on an explicitly requested width.
    p2_eff = p2 or (p if strategy in ("filter", "channel", "spatial") else 1)
    if strategy in ("df", "ds", "ep", "summa"):
        p1 = p1 or max(p // 16, 1)
        p2 = p2 or p // p1
    if strategy == "summa":
        p2r = p2r or (p2 // p2c if p2c else _balanced_divisor(p2))
        p2c = p2c or p2 // p2r
        # the residual stream a seq-parallel switch would shard lives on
        # the COLUMN ring (the row dim already shards the sequence)
        p2_eff = p2c
    if strategy == "serial":
        p, rp1, rp2 = 1, 1, 1
    elif strategy == "data":
        rp1, rp2 = p, 1
    elif strategy in ("spatial", "pipeline", "filter", "channel"):
        rp1, rp2 = 1, p
    else:
        rp1, rp2 = p1, p2
    r = _eval(T, strategy, cfg, tm.system, p, p1 or 1, p2 or 1, p2_eff,
              cfg.B, p2r=p2r, p2c=p2c)
    feasible = bool(r["feasible"])
    return Projection(strategy, int(p), int(rp1), int(rp2),
                      float(r["comp"]), float(r["ge"]), float(r["fb"]),
                      float(r["halo"]), float(r["p2p"]), float(r["mem"]),
                      feasible, _limit_str(strategy, T, cfg.B, feasible),
                      float(r["iters"]),
                      p2r=int(p2r or 1), p2c=int(p2c or 1))


def seq_flops_coeffs(mc, seq: int) -> "tuple[float, float]":
    """Fit per-sample forward FLOPs ≈ a·S + b·S² from two stat evaluations.

    Transformer forward cost is exactly linear-plus-quadratic in sequence
    length (attention scores are the only S² term), so two points pin the
    polynomial: evaluating the layer stats at S and S/2 gives
    b = 2(F(S) − 2·F(S/2))/S² and a = F(S)/S − b·S. The serving oracle
    (serve/oracle.py) differentiates this to price decode — the marginal
    cost of token L is a + 2bL — and integrates it for chunked prefill,
    without a per-length stats rebuild inside the sweep.
    """
    from .layer_stats import stats_for
    S = max(int(seq), 8)
    S += S % 2
    f1 = float(sum(st.flops_fwd for st in stats_for(mc, S)))
    f2 = float(sum(st.flops_fwd for st in stats_for(mc, S // 2)))
    b = 2.0 * (f1 - 2.0 * f2) / (S * S)
    a = f1 / S - b * S
    return a, b


def project_all(stats, tm: TimeModel, cfg: OracleConfig, p: int,
                strategies=STRATEGY_NAMES) -> list[Projection]:
    out = []
    for s in strategies:
        if s == "serial" and p != 1:
            continue
        try:
            out.append(project(s, stats, tm, cfg, p))
        except ValueError:
            pass
    return out
