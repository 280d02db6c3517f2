"""Compatibility shim, as the reference's ``repro.parallel.pipeline``: the
pipeline layer lives in ``repro_torch.parallel.schedules``."""
from .schedules import (  # noqa: F401
    SCHEDULES,
    SCHEDULE_NAMES,
    clip_segments,
    gather_pipeline_state,
    gpipe,
    interleaved,
    make_pipeline_train_step,
    model_pipe_blocks,
    one_f_one_b,
    pipeline_block_costs,
    pipeline_block_count,
    pipeline_supported,
    resolve_segments,
)
