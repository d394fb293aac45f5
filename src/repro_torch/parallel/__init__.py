"""Feature sharding of the SPM operator (port of ``repro/parallel``: the
mesh context, ``data_axes`` and the step-serial two_level executor)."""

from repro_torch.parallel.ctx import (FeatureMesh,  # noqa: F401
                                      activation_sharding, feature_mesh,
                                      make_feature_mesh)
from repro_torch.parallel.sharding import data_axes  # noqa: F401
