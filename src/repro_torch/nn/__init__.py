from .module import (ShardingCtx, constant, fan_in_normal, resolve_device,
                     zeros_like_spec)
from .layers import (BatchNorm, Conv, Dense, Embedding, RMSNorm,
                     global_avg_pool, max_pool)
