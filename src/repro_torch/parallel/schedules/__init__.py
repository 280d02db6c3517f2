"""Pipeline parallelism, schedule-diverse: paper §3.4 "Layer" strategy, for
the paper's CNNs (counterpart of ``repro.parallel.schedules``).

  * ``runtime``    — the executors (``gpipe`` / ``one_f_one_b`` /
    ``interleaved``) on ``torch.distributed`` point-to-point;
  * ``hetero``     — the CNNs cut into ``PipeBlock``s, their costs from the
    oracle's layer stats, and the stage boundaries' shapes;
  * ``train_step`` — the deployable step: the cuts, the schedule, the loss
    on the last stage and each stage's update of the blocks it owns.

The reference's ``stages`` (stacked layouts for uniform LM trunks) is not
ported yet (ROADMAP queue 1 item 8). ``repro_torch.parallel.pipeline``
re-exports these names, as the reference's shim does.
"""
from .hetero import (PipeBlock, boundary_shapes, model_pipe_blocks,
                     pipeline_block_costs, pipeline_block_count)
from .runtime import (SCHEDULE_NAMES, SCHEDULES, gpipe, interleaved,
                      one_f_one_b)
from .train_step import (clip_segments, gather_pipeline_state,
                         make_pipeline_train_step, pipeline_supported,
                         resolve_segments)

__all__ = [
    "PipeBlock",
    "SCHEDULES",
    "SCHEDULE_NAMES",
    "boundary_shapes",
    "clip_segments",
    "gather_pipeline_state",
    "gpipe",
    "interleaved",
    "make_pipeline_train_step",
    "model_pipe_blocks",
    "one_f_one_b",
    "pipeline_block_costs",
    "pipeline_block_count",
    "pipeline_supported",
    "resolve_segments",
]
