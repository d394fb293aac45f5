"""zamba2-1.2b [hybrid]: 38L d=2048 32H (MHA kv=32) vocab=32000
ssm_state=64, a Mamba2 backbone with one shared attention + FFN block
(d_ff=8192) applied before every 6th layer — the same two configs as
``repro/configs/zamba2_1_2b.py``."""

from repro_torch.configs.base import hybrid_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = True

CONFIG = ModelConfig(
    name="zamba2-1.2b", d_model=2048, n_layers=38, n_heads=32,
    n_kv_heads=32, head_dim=64, d_ff=0, vocab_size=32000,
    layers=hybrid_layers(38, 6), scan_group=0,
    ssm_state=64, ssm_head=64, shared_attn_d_ff=8192,
    linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", d_model=64, n_layers=4, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=256,
    layers=hybrid_layers(4, 2), scan_group=0,
    ssm_state=16, ssm_head=16, ssm_chunk=8, shared_attn_d_ff=128,
    linear_impl="spm_general", spm_backward="custom",
    dtype="float32", q_chunk=16, k_chunk=16)
