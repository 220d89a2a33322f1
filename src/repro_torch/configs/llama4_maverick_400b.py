"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4; unverified]:
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1 +
shared expert, interleaved (MoE every 2nd layer), iRoPE: chunked-local
attention with a NoPE global layer every 4th.  bf16 params + Adafactor
(the reference's choice for its 400B AdamW-f32 state)."""
from repro_torch.configs.base import LMArch
from repro_torch.models.transformer.model import LMConfig

CFG = LMConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048,
    moe_experts=128, moe_top_k=1, moe_every=2, moe_shared=1,
    attn_pattern="chunked_global4", window=8192,
    rope_theta=500000.0, act="silu", param_dtype="bfloat16",
)
SMOKE = LMConfig(
    name="llama4-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=512, moe_experts=8, moe_top_k=1, moe_every=2,
    moe_shared=1, attn_pattern="chunked_global4", window=16,
    q_chunk=16, kv_chunk=16, capacity_factor=4.0,
)
ARCH = LMArch(CFG, optimizer="adafactor", smoke_cfg=SMOKE, accum=32)
