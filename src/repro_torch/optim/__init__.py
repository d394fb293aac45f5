"""Optimizer: AdamW, cosine schedule and global-norm clipping."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptimizerConfig, adamw_update, clip_by_global_norm, cosine_schedule,
    decay_mask, global_norm, init_opt_state)
