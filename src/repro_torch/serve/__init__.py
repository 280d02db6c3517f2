"""Serving: paged KV cache, continuous batching, serving oracle
(counterpart of ``repro.serve``)."""
from .engine import Engine, Request, RequestStats, ServeConfig, ServeReport
from .kv_cache import (NULL_BLOCK, BlockAllocator, CacheGeometry,
                       cache_geometry, gather_view, max_abs_diff, pool_spec,
                       scatter_blocks)
from .oracle import (SERVE_STRATEGIES, ServePlan, ServeProjection,
                     kv_bytes_per_token, price_serving, serve_sweep,
                     serve_tune)
from .traffic import TrafficModel

__all__ = [
    "Engine", "Request", "RequestStats", "ServeConfig", "ServeReport",
    "NULL_BLOCK", "BlockAllocator", "CacheGeometry", "cache_geometry",
    "gather_view", "max_abs_diff", "pool_spec", "scatter_blocks",
    "SERVE_STRATEGIES", "ServePlan", "ServeProjection",
    "kv_bytes_per_token", "price_serving", "serve_sweep", "serve_tune",
    "TrafficModel",
]
