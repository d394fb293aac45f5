"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936,
qk_norm — the same two configs as ``repro/configs/qwen3_1_7b.py``."""

from repro_torch.configs.base import dense_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = False

CONFIG = ModelConfig(
    name="qwen3-1.7b", d_model=2048, n_layers=28, n_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=6144, vocab_size=151936,
    layers=dense_layers(28), qk_norm=True,
    rope_theta=1e6, linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="qwen3-1.7b-smoke", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=96, vocab_size=256,
    layers=dense_layers(2), qk_norm=True,
    rope_theta=1e6, linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
