"""qwen3-32b [dense]: 64L d=5120 64H (GQA kv=8) d_ff=25600 vocab=151936,
qk_norm — the same two configs as ``repro/configs/qwen3_32b.py``.  With
every projection SPM it has 951.3 M parameters, 777.9 M of them the
vocabulary table, so it trains on one 80 GB card at full depth."""

from repro_torch.configs.base import dense_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = False   # pure full attention: long_500k is skipped

CONFIG = ModelConfig(
    name="qwen3-32b", d_model=5120, n_layers=64, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936,
    layers=dense_layers(64), qk_norm=True,
    rope_theta=1e6, linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="qwen3-32b-smoke", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256,
    layers=dense_layers(2), qk_norm=True,
    rope_theta=1e6, linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
