"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, MLP 400-400."""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys.models import (XDeepFMConfig, xdeepfm_forward,
                                              xdeepfm_init, xdeepfm_user_embedding)

CFG = XDeepFMConfig(field_vocab=1_048_576)
SMOKE = XDeepFMConfig(field_vocab=128, cin_layers=(16, 16), mlp=(32,))
ARCH = RecsysArch(CFG, xdeepfm_init, xdeepfm_forward, xdeepfm_user_embedding, seq=False)
ARCH.smoke_cfg = SMOKE
