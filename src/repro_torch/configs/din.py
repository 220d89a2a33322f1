"""din [arXiv:1706.06978]: embed_dim=18, 100-item history, attention MLP
80-40, MLP 200-80."""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys.models import (DINConfig, din_forward, din_init,
                                              din_user_embedding)

CFG = DINConfig(item_vocab=16_777_216)
SMOKE = DINConfig(item_vocab=256, seq_len=10)
ARCH = RecsysArch(CFG, din_init, din_forward, din_user_embedding, seq=True)
ARCH.smoke_cfg = SMOKE
