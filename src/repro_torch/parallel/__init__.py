"""Feature sharding of the SPM operator and a pod's rows (port of
``repro/parallel``: the mesh context, ``data_axes``, ``batch_spec`` and the
two_level executor)."""

from repro_torch.parallel.ctx import (FeatureMesh,  # noqa: F401
                                      activation_sharding, feature_mesh,
                                      make_feature_mesh)
from repro_torch.parallel.sharding import (batch_spec,  # noqa: F401
                                           data_axes, member_rows)
