"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) per-expert d_ff=768
vocab=151936, 128 experts top-8 — the same two configs as
``repro/configs/qwen3_moe_30b_a3b.py``."""

from repro_torch.configs.base import moe_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = False

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", d_model=2048, n_layers=48, n_heads=32,
    n_kv_heads=4, head_dim=128, d_ff=0, vocab_size=151936,
    layers=moe_layers(48), qk_norm=True,
    n_experts=128, top_k=8, moe_d_ff=768,
    rope_theta=1e6, linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=0, vocab_size=256,
    layers=moe_layers(2), qk_norm=True,
    n_experts=8, top_k=2, moe_d_ff=32,
    rope_theta=1e6, linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
