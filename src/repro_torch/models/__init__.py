"""Model compositions: the transformer composer and causal-LM heads, the
paper's MLP students, and the §6 GRU-LM."""

from repro_torch.models.mlp import (MLPConfig, init_mlp,  # noqa: F401
                                    mlp_apply, mlp_loss)
from repro_torch.models.gru_lm import (GRULMConfig,  # noqa: F401
                                       gru_lm_forward, gru_lm_loss,
                                       init_gru_lm)
