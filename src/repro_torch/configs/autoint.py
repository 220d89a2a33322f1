"""autoint [arXiv:1810.11921]: 39 fields, embed_dim=16, 3 self-attn layers,
2 heads, d_attn=32."""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys.models import (AutoIntConfig, autoint_forward,
                                              autoint_init, autoint_user_embedding)

CFG = AutoIntConfig(field_vocab=1_048_576)
SMOKE = AutoIntConfig(field_vocab=128, d_attn=8)
ARCH = RecsysArch(CFG, autoint_init, autoint_forward, autoint_user_embedding, seq=False)
ARCH.smoke_cfg = SMOKE
