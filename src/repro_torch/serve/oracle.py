"""Oracle rows for serving: price TTFT / latency percentiles / tok/s (the
port's copy of ``repro.serve.oracle``: plain arithmetic on the config, the
same numbers to 1e-12, tests/test_torch_serve_oracle.py).

Same move as the training oracle (paper §4, arXiv 2104.09075) — analytic
compute + α–β communication from the machine description — but the
quantity priced is request latency under traffic, not step time:

  * per-token decode cost comes from differentiating the fitted
    per-sample FLOPs polynomial a·S + b·S² (core/oracle.seq_flops_coeffs):
    token at context L costs a + 2bL FLOPs, roofline'd against weight +
    KV reads from HBM (decode is bandwidth-bound at small batch);
  * prefill integrates the same polynomial over the prompt
    (compute-bound);
  * each replica of ``p2`` model-parallel PEs is an M/D/1 queue serving
    ``max_batch`` requests concurrently: deterministic service time
    T = t_prefill + gen_len·t_decode, arrival rate λ/p1, utilization
    ρ = λT/(p1·max_batch), mean wait Wq = ρ/(2μ(1−ρ)) with an
    exponential-tail read-off for percentiles (p50 = ln2·Wq,
    p99 = ln100·Wq).

Strategies price the reference's two serving rules tables:
``serve_tp`` (Megatron-style tensor parallel, 2 collectives/layer, KV
sharded over heads) and ``serve_seqkv`` (sequence-sharded KV /
flash-decoding, 3 collectives/layer for the extra LSE merge, KV sharded
over the cache span). ``serve_tune`` sweeps (strategy, p1·p2, kv_shards,
max_batch) and picks the highest-throughput plan meeting the p99 SLO.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.autotune import stats_for_model
from ..core.oracle import seq_flops_coeffs

__all__ = ["SERVE_STRATEGIES", "ServeProjection", "ServePlan",
           "kv_bytes_per_token", "price_serving", "serve_sweep",
           "serve_tune"]

SERVE_STRATEGIES = ("serve_tp", "serve_seqkv")

# collectives per transformer layer per token-batch (fw only — no grads)
_COLLS = {"serve_tp": 2, "serve_seqkv": 3}

_LN2, _LN100 = math.log(2.0), math.log(100.0)


def kv_bytes_per_token(mc, dtype_bytes: int = 2) -> int:
    """Analytic K+V bytes one token pins in the cache, summed over layers.

    Mirrors what ``serve.kv_cache.cache_geometry`` measures on the real
    cache, but from the config alone. Only attention layers are
    paged-servable, matching the engine's geometry gate.
    """
    pattern = getattr(mc, "pattern", None) or ("attn",)
    n_layers = getattr(mc, "n_layers", 0)
    total = 0
    for i in range(n_layers):
        kind = pattern[i % len(pattern)]
        ac = None
        if kind == "attn":
            ac = getattr(mc, "attn", None)
        elif kind == "local":
            ac = getattr(mc, "local_attn", None) or getattr(mc, "attn", None)
        if ac is None:
            raise ValueError(
                f"layer kind {kind!r} has no pageable KV cache — the "
                "serving oracle prices attention-only models")
        total += 2 * ac.n_kv_heads * ac.head_dim * dtype_bytes
    return total


@dataclass(frozen=True)
class ServeProjection:
    """One priced serving configuration (one row of the serve sweep)."""

    strategy: str
    p1: int                 # data-parallel replicas
    p2: int                 # model-parallel width per replica
    kv_shards: int          # cache span shards (1 | p2)
    max_batch: int          # continuous-batch width per replica
    t_prefill: float        # s, one mean prompt through one replica
    t_decode: float         # s, one decode step of the full batch
    rho: float              # replica utilization (λ·T / (p1·max_batch))
    ttft_p50: float
    ttft_p99: float
    latency_p50: float
    latency_p99: float
    tok_per_s: float        # deployment decode-token capacity
    mem_bytes: float        # per-PE weights + KV footprint
    feasible: bool
    limit: str = ""         # why not, when infeasible

    def meets(self, slo_p99: float) -> bool:
        return self.feasible and self.latency_p99 <= slo_p99

    def describe(self) -> str:
        if not self.feasible:
            return (f"{self.strategy:<11} p1={self.p1:<3} p2={self.p2:<3} "
                    f"kv={self.kv_shards:<3} B={self.max_batch:<3} "
                    f"infeasible ({self.limit})")
        return (f"{self.strategy:<11} p1={self.p1:<3} p2={self.p2:<3} "
                f"kv={self.kv_shards:<3} B={self.max_batch:<3} "
                f"rho={self.rho:5.2f} ttft_p50={self.ttft_p50 * 1e3:8.2f}ms "
                f"p99={self.latency_p99 * 1e3:9.2f}ms "
                f"tok/s={self.tok_per_s:10.1f}")


def price_serving(mc, system, strategy: str, p1: int, p2: int,
                  kv_shards: int, max_batch: int, traffic, *,
                  max_len: int | None = None, dtype_bytes: int = 2,
                  prefill_chunk: int = 32) -> ServeProjection:
    """Price one (strategy, p1, p2, kv_shards, max_batch) configuration
    under ``traffic`` (a TrafficModel). ``system``: SystemModel or
    ClusterSpec."""
    sysm = getattr(system, "system", system)
    max_len = max_len or _round_up(traffic.prompt_len + traffic.gen_len, 64)

    def bail(why):
        return ServeProjection(strategy, p1, p2, kv_shards, max_batch,
                               0.0, 0.0, float("inf"), float("inf"),
                               float("inf"), float("inf"), float("inf"),
                               0.0, 0.0, False, why)

    # -- structural feasibility of the rules table on this width ----------
    ac = getattr(mc, "attn", None)
    if ac is None:
        return bail("no attention config")
    if strategy == "serve_tp":
        if kv_shards != 1:
            return bail("serve_tp shards KV over heads; kv_shards must be 1")
        if ac.n_kv_heads % p2 or ac.n_heads % p2:
            return bail(f"heads ({ac.n_heads}/{ac.n_kv_heads}) % p2 != 0")
    elif strategy == "serve_seqkv":
        if kv_shards != p2:
            return bail("serve_seqkv shards the cache span; kv_shards == p2")
        if max_len % p2:
            return bail(f"max_len {max_len} % p2 != 0")
    else:
        raise ValueError(f"unknown serving strategy {strategy!r}")

    a, b = seq_flops_coeffs(mc, max_len)
    kv_tok = kv_bytes_per_token(mc, dtype_bytes)
    w_bytes = _weight_bytes(mc, max_len, dtype_bytes)
    lp, lg = traffic.prompt_len, traffic.gen_len
    mean_ctx = traffic.mean_context
    d = mc.d_model
    n_layers = mc.n_layers
    level = sysm.level("model")
    eff = sysm.peak_flops * sysm.compute_efficiency

    # KV divides across the replica iff the strategy actually shards it
    kv_div = p2 if (strategy == "serve_seqkv"
                    or (strategy == "serve_tp" and p2 > 1)) else 1

    # -- memory gate -------------------------------------------------------
    mem = (w_bytes / p2
           + max_batch * max_len * kv_tok / kv_div)
    if mem > sysm.mem_capacity:
        return bail(f"per-PE mem {mem / 1e9:.2f} GB > "
                    f"{sysm.mem_capacity / 1e9:.2f} GB")

    # -- prefill: compute-bound pass over the prompt -----------------------
    flops_pf = a * lp + b * lp * lp
    chunks = max(-(-lp // prefill_chunk), 1)
    comm_pf = (_COLLS[strategy] * n_layers
               * level.allreduce(p2, lp * d * dtype_bytes))
    t_pf = max(flops_pf / (p2 * eff),
               chunks * (w_bytes / p2) / sysm.hbm_bw) + comm_pf

    # -- decode: roofline of marginal FLOPs vs weight + KV reads -----------
    flops_dec = max_batch * (a + 2 * b * mean_ctx)
    bytes_dec = (w_bytes / p2
                 + max_batch * mean_ctx * kv_tok / kv_div)
    comm_dec = (_COLLS[strategy] * n_layers
                * level.allreduce(p2, max_batch * d * dtype_bytes))
    t_dec = max(flops_dec / (p2 * eff), bytes_dec / sysm.hbm_bw) + comm_dec

    # -- M/D/1 queue per replica ------------------------------------------
    t_req = t_pf + lg * t_dec                  # deterministic service time
    mu = max_batch / t_req                     # replica service rate, req/s
    lam = traffic.rate / p1
    rho = lam / mu
    cap_tok = p1 * max_batch * lg / t_req      # deployment token capacity
    if rho >= 1.0:
        return ServeProjection(strategy, p1, p2, kv_shards, max_batch,
                               t_pf, t_dec, rho, float("inf"), float("inf"),
                               float("inf"), float("inf"), cap_tok,
                               mem, False, f"overloaded (rho={rho:.2f})")
    wq = rho / (2 * mu * (1 - rho))            # M/D/1 mean queue wait
    return ServeProjection(
        strategy, p1, p2, kv_shards, max_batch, t_pf, t_dec, rho,
        ttft_p50=_LN2 * wq + t_pf, ttft_p99=_LN100 * wq + t_pf,
        latency_p50=_LN2 * wq + t_req, latency_p99=_LN100 * wq + t_req,
        tok_per_s=cap_tok, mem_bytes=mem, feasible=True)


def serve_sweep(mc, system, p: int, traffic, *,
                strategies=SERVE_STRATEGIES,
                max_batches=(1, 2, 4, 8, 16, 32),
                max_len: int | None = None,
                dtype_bytes: int = 2) -> "list[ServeProjection]":
    """Every (strategy, p1·p2 = p, kv_shards, max_batch) row priced."""
    rows = []
    for p2 in _divisors(p):
        p1 = p // p2
        for strat in strategies:
            kv = 1 if strat == "serve_tp" else p2
            for mb in max_batches:
                rows.append(price_serving(
                    mc, system, strat, p1, p2, kv, mb, traffic,
                    max_len=max_len, dtype_bytes=dtype_bytes))
    return rows


@dataclass(frozen=True)
class ServePlan:
    """serve_tune's answer: the winning row + the best alternative."""

    winner: ServeProjection
    runner_up: "ServeProjection | None"
    slo_p99: float
    meets_slo: bool
    rows: tuple                    # full priced sweep, ranked

    def describe(self) -> str:
        head = ("plan meets p99 SLO" if self.meets_slo else
                "NO plan meets the p99 SLO — least-bad row")
        lines = [f"{head} ({self.slo_p99 * 1e3:.0f} ms):",
                 "  " + self.winner.describe()]
        if self.runner_up is not None:
            lines.append("  runner-up:")
            lines.append("  " + self.runner_up.describe())
        return "\n".join(lines)


def _rank_key(r: ServeProjection):
    # max tok/s, then tightest p99, then narrowest replica, serve_tp first
    return (-r.tok_per_s, r.latency_p99, r.p2,
            0 if r.strategy == "serve_tp" else 1, r.p1)


def serve_tune(mc, system, p: int, traffic, slo_p99: float,
               **sweep_kw) -> ServePlan:
    """Highest-throughput feasible plan meeting the p99 latency SLO.

    Falls back to the minimum-p99 feasible row (flagged ``meets_slo=False``)
    when nothing meets the SLO, so callers always get a deployable plan
    plus the evidence of the miss.
    """
    rows = serve_sweep(mc, system, p, traffic, **sweep_kw)
    ok = sorted((r for r in rows if r.meets(slo_p99)), key=_rank_key)
    if ok:
        return ServePlan(ok[0], ok[1] if len(ok) > 1 else None,
                         slo_p99, True, tuple(ok))
    feas = sorted((r for r in rows if r.feasible),
                  key=lambda r: (r.latency_p99, -r.tok_per_s))
    if not feas:
        raise ValueError(
            f"no feasible serving configuration at p={p} for {traffic} "
            f"(every row: memory-gated or overloaded)")
    return ServePlan(feas[0], feas[1] if len(feas) > 1 else None,
                     slo_p99, False, tuple(feas))


# ---------------------------------------------------------------------------
def _divisors(p: int) -> "list[int]":
    return [k for k in range(1, p + 1) if p % k == 0]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _weight_bytes(mc, seq: int, dtype_bytes: int) -> float:
    return float(sum(st.w for st in stats_for_model(mc, seq))) * dtype_bytes
