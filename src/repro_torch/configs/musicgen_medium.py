"""musicgen-medium [audio]: 48L d=1536 24H (MHA kv=24) d_ff=6144
vocab=2048, a decoder over EnCodec tokens — the backbone of the same two
configs as ``repro/configs/musicgen_medium.py``.  The EnCodec frontend is a
stub: training takes frame embeddings (B, T, d); serving decodes the
model's own 2048-token codebook after a token prompt."""

from repro_torch.configs.base import dense_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = False

CONFIG = ModelConfig(
    name="musicgen-medium", d_model=1536, n_layers=48, n_heads=24,
    n_kv_heads=24, head_dim=64, d_ff=6144, vocab_size=2048,
    layers=dense_layers(48), input_kind="embeddings",
    rope_theta=1e4, linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
    layers=dense_layers(2), input_kind="embeddings",
    rope_theta=1e4, linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
