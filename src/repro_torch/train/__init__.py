"""The training substrate: optimizers, accumulation, checkpoints, the loop.

``compression`` and ``elastic`` wait for a later slice (ROADMAP Queue 1
item 9, slice 17).
"""

from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
from .grad import make_train_step
from .loop import TrainLoopConfig, run_train_loop
from .optimizer import (AdafactorState, AdamWConfig, AdamWState, adafactor_init,
                        adafactor_update, adamw_init, adamw_update,
                        cosine_schedule, global_norm)

__all__ = [
    "AsyncCheckpointer", "latest_step", "restore_checkpoint", "save_checkpoint",
    "make_train_step", "TrainLoopConfig", "run_train_loop",
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
    "AdafactorState", "adafactor_init", "adafactor_update", "global_norm",
]
