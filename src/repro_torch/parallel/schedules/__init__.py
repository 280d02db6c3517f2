"""Pipeline parallelism, schedule-diverse: paper §3.4 "Layer" strategy, for
the paper's CNNs and the LMs (counterpart of ``repro.parallel.schedules``).

  * ``runtime``    — the executors (``gpipe`` / ``one_f_one_b`` /
    ``interleaved``) on ``torch.distributed`` point-to-point;
  * ``hetero``     — the CNNs and the LMs (uniform and mixed patterns) cut
    into ``PipeBlock``s, their costs from the oracle's layer stats, and the
    stage boundaries' shapes;
  * ``stages``     — which layers each rank runs (the assignment the
    reference's padded stacked layouts encode) and the per-layer costs;
  * ``train_step`` — the deployable step: the cuts, the schedule, an LM's
    embedding on the first stage, the loss on the last and each stage's
    update of the blocks it owns.

``repro_torch.parallel.pipeline`` re-exports these names, as the
reference's shim does.
"""
from .hetero import (PipeBlock, boundary_shapes, model_pipe_blocks,
                     pipeline_block_costs, pipeline_block_count)
from .runtime import (SCHEDULE_NAMES, SCHEDULES, gpipe, interleaved,
                      one_f_one_b)
from .stages import (block_costs_from_stats, stack_stage_bounds,
                     stack_virtual_stage_bounds)
from .train_step import (clip_segments, gather_pipeline_state,
                         make_pipeline_train_step, pipeline_supported,
                         resolve_segments)

__all__ = [
    "PipeBlock",
    "SCHEDULES",
    "SCHEDULE_NAMES",
    "block_costs_from_stats",
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
    "stack_stage_bounds",
    "stack_virtual_stage_bounds",
]
