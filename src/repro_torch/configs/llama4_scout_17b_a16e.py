"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, 16 experts top-1 plus an always-on shared expert — the same
two configs as ``repro/configs/llama4_scout_17b_a16e.py``."""

from repro_torch.configs.base import moe_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = False

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", d_model=5120, n_layers=48, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=0, vocab_size=202048,
    layers=moe_layers(48),
    n_experts=16, top_k=1, moe_d_ff=8192, shared_d_ff=8192,
    rope_theta=5e5, linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="llama4-scout-smoke", d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=0, vocab_size=256,
    layers=moe_layers(2),
    n_experts=4, top_k=1, moe_d_ff=64, shared_d_ff=64,
    rope_theta=5e5, linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
