"""Config layer: the LM family's architecture record.

``LMArch`` holds an architecture's full config, its optimizer, the input
shapes it is measured at (``SHAPES``, the reference's table), the shapes
it skips, an ``accum`` override and the reduced ``smoke()`` config.  The
reference's ``cell()`` (a step function with abstract arguments and
PartitionSpecs for the pod dry-run) belongs to the dry-run slice (ROADMAP
Queue 1 item 9, slice 17).
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.models.transformer.model import LMConfig


class LMArch:
    family = "lm"
    SHAPES = {
        # accum=8: microbatched grad accumulation keeps the (B, S, V) logits
        # tensor at 1/8 size
        "train_4k": dict(kind="train", seq=4096, batch=256, accum=8),
        "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
        "decode_32k": dict(kind="decode", seq=32768, batch=128),
        "long_500k": dict(kind="decode", seq=524288, batch=1, seq_sharded=True),
    }

    def __init__(self, cfg: LMConfig, optimizer: str = "adamw",
                 skip_shapes: Tuple[str, ...] = (), smoke_cfg=None,
                 accum: Optional[int] = None):
        self.cfg = cfg
        self.optimizer = optimizer
        self.skip_shapes = skip_shapes
        self._smoke = smoke_cfg
        self.accum = accum              # override SHAPES accum (MoE memory)

    def smoke(self):
        return self._smoke
