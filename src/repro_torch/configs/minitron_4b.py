"""minitron-4b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=9216 vocab=256000,
a pruned nemotron — the same two configs as
``repro/configs/minitron_4b.py``."""

from repro_torch.configs.base import dense_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = False

CONFIG = ModelConfig(
    name="minitron-4b", d_model=3072, n_layers=32, n_heads=24, n_kv_heads=8,
    head_dim=128, d_ff=9216, vocab_size=256000,
    layers=dense_layers(32),
    rope_theta=1e4, linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="minitron-4b-smoke", d_model=48, n_layers=2, n_heads=6, n_kv_heads=2,
    head_dim=8, d_ff=144, vocab_size=250,
    layers=dense_layers(2),
    rope_theta=1e4, linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
