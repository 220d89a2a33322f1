"""starcoder2-3b [arXiv:2402.19173]: 30L d_model=3072 24H (GQA kv=2)
d_ff=12288 vocab=49152, SWA-4096, RoPE, biases on."""
from repro_torch.configs.base import LMArch
from repro_torch.models.transformer.model import LMConfig

CFG = LMConfig(
    name="starcoder2-3b",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
    d_ff=12288, vocab=49152,
    attn_pattern="swa", window=4096, qkv_bias=True, act="gelu",
    rope_theta=100000.0,
)
SMOKE = LMConfig(
    name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=512, attn_pattern="swa", window=16,
    qkv_bias=True, act="gelu", q_chunk=16, kv_chunk=16,
)
ARCH = LMArch(CFG, smoke_cfg=SMOKE)
