"""The training substrate: optimizers, accumulation, checkpoints, the loop.

``compression`` holds top-k with error feedback and int8 quantization;
``elastic`` (imported as ``repro_torch.train.elastic``: it reads the
sharding rules, which read ``train.tree``) re-places a tree on another
mesh.
"""

from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
from .compression import compressed_psum, ef_topk_step, int8_dequantize, int8_quantize
from .grad import make_train_step
from .loop import TrainLoopConfig, run_train_loop
from .optimizer import (AdafactorState, AdamWConfig, AdamWState, adafactor_init,
                        adafactor_update, adamw_init, adamw_update,
                        cosine_schedule, global_norm)

__all__ = [
    "AsyncCheckpointer", "latest_step", "restore_checkpoint", "save_checkpoint",
    "compressed_psum", "ef_topk_step", "int8_dequantize", "int8_quantize",
    "make_train_step", "TrainLoopConfig", "run_train_loop",
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
    "AdafactorState", "adafactor_init", "adafactor_update", "global_norm",
]
