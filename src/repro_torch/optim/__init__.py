from .optimizers import (OptimizerConfig, apply_update, clip_scale,
                         global_norm, init_state)
