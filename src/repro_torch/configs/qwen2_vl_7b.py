"""qwen2-vl-7b [vlm]: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
M-RoPE with (16, 24, 24) sections — the backbone of the same two configs
as ``repro/configs/qwen2_vl_7b.py``.  The ViT frontend is a stub: training
takes patch embeddings (B, T, d) and (3, B, T) M-RoPE ids; serving decodes
text tokens after a token prompt."""

from repro_torch.configs.base import dense_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = False

CONFIG = ModelConfig(
    name="qwen2-vl-7b", d_model=3584, n_layers=28, n_heads=28, n_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064,
    layers=dense_layers(28), input_kind="embeddings",
    rope_kind="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256,
    layers=dense_layers(2), input_kind="embeddings",
    rope_kind="mrope", mrope_sections=(2, 3, 3), rope_theta=1e6,
    linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
