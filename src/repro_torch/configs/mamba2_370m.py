"""mamba2-370m [ssm]: 48L d=1024 attention-free vocab=50280 ssm_state=128
— the same two configs as ``repro/configs/mamba2_370m.py``.  SPM applies
to the in and out projections; the SSD scan is left as it is."""

from repro_torch.configs.base import mamba_layers
from repro_torch.models.transformer import ModelConfig

SUBQUADRATIC = True

CONFIG = ModelConfig(
    name="mamba2-370m", d_model=1024, n_layers=48, n_heads=16,
    n_kv_heads=16, head_dim=64, d_ff=0, vocab_size=50280,
    layers=mamba_layers(48),
    ssm_state=128, ssm_head=64,
    linear_impl="spm_general", spm_backward="custom")

SMOKE = ModelConfig(
    name="mamba2-370m-smoke", d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=256,
    layers=mamba_layers(2),
    ssm_state=16, ssm_head=16, ssm_chunk=8,
    linear_impl="spm_general", spm_backward="custom",
    dtype="float32")
