"""bst [arXiv:1905.06874]: embed_dim=32, 20-item behaviour sequence,
1 transformer block x 8 heads, MLP 1024-512-256."""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys.models import (BSTConfig, bst_forward, bst_init,
                                              bst_user_embedding)

CFG = BSTConfig(item_vocab=16_777_216)
SMOKE = BSTConfig(item_vocab=256, seq_len=8, mlp=(64, 32))
ARCH = RecsysArch(CFG, bst_init, bst_forward, bst_user_embedding, seq=True)
ARCH.smoke_cfg = SMOKE
