from .optimizers import (OptimizerConfig, apply_update, clip_by_global_norm,
                         global_norm, init_state)
