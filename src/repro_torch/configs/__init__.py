"""Architecture configs: ``qwen3-1.7b`` (full and smoke) and the registry."""

from repro_torch.configs.base import (dense_layers,  # noqa: F401
                                      with_feature_sharding,
                                      with_overlap_executor,
                                      with_fused_linears, with_overrides,
                                      with_quantized_io)
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: F401
                                          get_smoke)
