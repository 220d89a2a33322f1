"""gemma2-27b [arXiv:2408.00118]: 46L d_model=4608 32H (GQA kv=16)
d_ff=36864 vocab=256000, local(4096)+global alternating, logit softcaps."""
from repro_torch.configs.base import LMArch
from repro_torch.models.transformer.model import LMConfig

CFG = LMConfig(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=36864, vocab=256000,
    attn_pattern="alt_local_global", window=4096,
    softcap_attn=50.0, softcap_final=30.0,
    embed_scale=True, act="gelu", rope_theta=10000.0,
)
SMOKE = LMConfig(
    name="gemma2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=256, vocab=512, attn_pattern="alt_local_global", window=16,
    softcap_attn=50.0, softcap_final=30.0, embed_scale=True, act="gelu",
    q_chunk=16, kv_chunk=16,
)
ARCH = LMArch(CFG, smoke_cfg=SMOKE)
