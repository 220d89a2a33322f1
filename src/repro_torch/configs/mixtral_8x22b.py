"""mixtral-8x22b [arXiv:2401.04088]: 56L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=32768, MoE 8e top-2, SWA (per assignment)."""
from repro_torch.configs.base import LMArch
from repro_torch.models.transformer.model import LMConfig

CFG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=32768,
    moe_experts=8, moe_top_k=2,
    attn_pattern="swa", window=4096, rope_theta=1000000.0, act="silu",
)
SMOKE = LMConfig(
    name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=512, moe_experts=4, moe_top_k=2,
    attn_pattern="swa", window=16, q_chunk=16, kv_chunk=16, capacity_factor=4.0,
)
ARCH = LMArch(CFG, smoke_cfg=SMOKE, accum=32)
