"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local:global with 1024-token sliding windows, local RoPE theta 1e4,
``embed_scale`` sqrt(d) — the same two configs as
``repro/configs/gemma3_12b.py``."""

from repro_torch.configs.base import local_global_layers
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", d_model=3840, n_layers=48, n_heads=16, n_kv_heads=8,
    head_dim=256, d_ff=15360, vocab_size=262144,
    layers=local_global_layers(48, 5, 1024), scan_group=6, qk_norm=True,
    rope_theta=1e6, rope_local_theta=1e4, embed_scale=3840 ** 0.5,
    linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="gemma3-12b-smoke", d_model=64, n_layers=6, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=512,
    layers=local_global_layers(6, 5, 8), scan_group=6, qk_norm=True,
    rope_theta=1e6, rope_local_theta=1e4, embed_scale=8.0,
    linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
