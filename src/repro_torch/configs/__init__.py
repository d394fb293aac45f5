"""Architecture configs: the reference's ten archs (full and smoke), the
registry and the input shapes of its cells."""

from repro_torch.configs.base import (dense_layers,  # noqa: F401
                                      hybrid_layers, local_global_layers,
                                      mamba_layers, moe_layers,
                                      with_compressed_pod_grads,
                                      with_feature_sharding,
                                      with_overlap_executor,
                                      with_fused_linears, with_overrides,
                                      with_quantized_io)
from repro_torch.configs.registry import (ARCH_IDS, all_cells,  # noqa: F401
                                          arch_shapes, get_config,
                                          get_smoke, is_subquadratic)
from repro_torch.configs.shapes import (LM_SHAPES, SHAPES,  # noqa: F401
                                        ShapeSpec)
