"""qwen2-0.5b [arXiv:2407.10671]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias, tied embeddings, pure full attention.
long_500k is SKIPPED by rule: pure full attention has no sub-quadratic
path."""
from repro_torch.configs.base import LMArch
from repro_torch.models.transformer.model import LMConfig

CFG = LMConfig(
    name="qwen2-0.5b",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab=151936,
    attn_pattern="full", qkv_bias=True, tied_embeddings=True,
    rope_theta=1000000.0, act="silu",
)
SMOKE = LMConfig(
    name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=512, attn_pattern="full", qkv_bias=True,
    tied_embeddings=True, q_chunk=16, kv_chunk=16,
)
ARCH = LMArch(CFG, skip_shapes=("long_500k",), smoke_cfg=SMOKE)
