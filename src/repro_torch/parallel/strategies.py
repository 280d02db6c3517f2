"""Parallel strategies as logical-axis → mesh-axis rule tables (the
reference's ``repro.parallel.strategies``, copied whole).

This is the executable form of the paper's §3 taxonomy. Each strategy is one
``Rules`` table; swapping tables re-parallelizes a model with no model code
changes. Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod; the DP group spans ("pod", "data").

paper §3.1 data      → batch over every axis, params replicated
paper §3.2 spatial   → seq (or image H/W) over model; params replicated ("ds"
                       when combined with batch over data)
paper §3.3 filter    → heads/mlp/filters (output channels) over model
paper §3.3 channel   → embed/input channels over model (row-parallel)
paper §3.4 layer     → pipeline stages: params shard over "layers"
paper §3.5 hybrid    → df / ds compositions
beyond-paper         → ZeRO-1/3 (optimizer/param sharding over data),
                       expert parallelism, sequence-parallel residual stream

The port executes the paper's rows (data, spatial, filter, channel, df,
ds) on ``torch.distributed`` for the CNNs and the LMs, df_zero1 and
df_zero3 for the LMs, "pipeline" through the stage executor
(``parallel/schedules``) and "summa" for the attention LMs on a grid mesh
(``parallel/summa.py``); the other tables resolve but no port model runs
under them yet (ROADMAP queue 1).
"""
from __future__ import annotations


from ..nn.module import Rules

# DP axes: "pod" is a prefix axis that only exists in the multi-pod mesh.
# Rules name both; spec_to_pspec skips axes missing from the mesh.
DP = ("pod", "data")
ALL = ("pod", "data", "model")


def _act_common(seq_parallel: bool = True):
    """Activation axes shared by the hybrid strategies."""
    table = {
        "batch": DP,
        "act_heads": "model",
        "act_kv": "model",
        "act_mlp": "model",
    }
    if seq_parallel:
        table["seq"] = "model"  # residual stream sequence-parallel (Megatron-SP)
    return table


STRATEGIES: dict[str, dict] = {
    # --- pure strategies (paper §3.1–3.4) --------------------------------
    "data": {"batch": ALL},
    "spatial": {"spatial": "model", "seq": "model", "batch": DP},
    # layer (pipeline): the rules table only places the stacked block
    # parameters — their leading "layers" axis shards over the model axis so
    # each rank holds its stages' weights, everything else replicates.
    "pipeline": {"layers": "model"},
    "filter": {**_act_common(), "heads": ("data", "model"),
               "kv_heads": ("data", "model"), "mlp": ("data", "model"),
               "conv_out": ("data", "model"), "batch": ("pod",)},
    "channel": {**_act_common(), "embed": ("data", "model"),
                "conv_in": ("data", "model"), "batch": ("pod",)},
    # --- hybrids (paper §3.5) ---------------------------------------------
    "df": {**_act_common(), "heads": "model", "kv_heads": "model",
           "mlp": "model", "experts": "model", "conv_out": "model",
           "vocab": "model"},
    "ds": {"batch": DP, "seq": "model", "spatial": "model"},
    # --- beyond paper -------------------------------------------------------
    # df + ZeRO-3: parameters additionally sharded over the data axis on
    # their embed/vocab dims (gathered on the fly by the partitioner).
    "df_zero3": {**_act_common(), "heads": "model", "kv_heads": "model",
                 "mlp": "model", "experts": "model", "conv_out": "model",
                 "embed": "data", "vocab": "model", "state": None,
                 "qk_rank": "model", "kv_rank": "model"},
    # df + ZeRO-1 (optimizer states sharded in optim/, params replicated
    # over data)
    "df_zero1": {**_act_common(), "heads": "model", "kv_heads": "model",
                 "mlp": "model", "experts": "model", "conv_out": "model",
                 "vocab": "model"},
    # expert parallelism for MoE + df for attention + ZeRO-3
    "ep_df": {**_act_common(), "experts": "model", "heads": "model",
              "kv_heads": "model", "mlp": None, "embed": "data",
              "vocab": "model", "qk_rank": "model", "kv_rank": "model"},
    # 2D (SUMMA) tensor grid: the model axis factors as model_r × model_c.
    # seq + weight K-dims ride the rows, hidden/filter dims ride the
    # columns → the residual stream is 2D-sharded; on a mesh without the
    # grid axes the table degrades to fully-replicated (safe).
    "summa": {"batch": DP, "seq": "model_r",
              "act_embed": "model_c", "act_mlp": "model_c",
              "act_heads": "model_c", "act_kv": "model_c",
              "embed": "model_r", "mlp": "model_c",
              "heads": "model_c", "kv_heads": "model_c",
              "conv_in": "model_r", "conv_out": "model_c",
              "vocab": "model_c"},
    # serving: no ZeRO (weights gathered once, latency-critical), TP on model
    "serve_tp": {**_act_common(seq_parallel=False), "heads": "model",
                 "kv_heads": "model", "mlp": "model", "experts": "model",
                 "vocab": "model", "seq": "model"},
    # serving with the sequence-sharded (flash-decoding) KV cache layout:
    # the cache's shard dim claims the model axis ("seq"), heads replicate.
    "serve_seqkv": {"batch": DP, "seq": "model", "heads": "model",
                    "kv_heads": "model", "mlp": "model", "experts": "model",
                    "vocab": "model", "act_mlp": "model", "act_heads": None,
                    "act_kv": None},
}


def make_rules(strategy: str) -> Rules:
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy!r}; "
                       f"known: {sorted(STRATEGIES)}")
    return Rules.of({k: v for k, v in STRATEGIES[strategy].items()
                     if v is not None})


def list_strategies() -> list[str]:
    return sorted(STRATEGIES)
