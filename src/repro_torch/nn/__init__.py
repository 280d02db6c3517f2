from .module import ShardingCtx, constant, fan_in_normal, resolve_device
from .layers import BatchNorm, Conv, Dense, global_avg_pool, max_pool
