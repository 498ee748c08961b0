"""Training: AdamW and its schedules, gradient compression, the losses, the
train steps (eager, captured once as a CUDA graph, stitched, sharded over
a mesh) and the fault-tolerant ``Trainer`` — the reference's
``repro.train`` in torch.

``__all__`` holds the names ``repro.train`` imports, then the port's own.
"""
from .optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_init_specs,
    adamw_update,
    adamw_update_,
    clip_by_global_norm,
    global_norm,
    lr_at,
)
from .sharded import gather_tree, make_sharded_train_step, rank_rows, row_axes
from .trainer import (
    CapturedTrainStep,
    FailureInjector,
    StragglerWatchdog,
    Trainer,
    TrainerConfig,
    cross_entropy,
    cross_entropy_sums,
    make_loss_fn,
    make_loss_sums_fn,
    make_stitched_train_step,
    make_train_step,
    value_and_grad,
)

__all__ = [
    # repro.train's
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_init_specs", "adamw_update",
    "lr_at", "FailureInjector", "StragglerWatchdog", "Trainer", "TrainerConfig",
    "cross_entropy", "make_loss_fn", "make_stitched_train_step", "make_train_step",
    # the port's own
    "adamw_update_", "clip_by_global_norm", "global_norm", "CapturedTrainStep",
    "cross_entropy_sums", "value_and_grad", "make_loss_sums_fn",
    "make_sharded_train_step", "gather_tree", "rank_rows", "row_axes",
]
