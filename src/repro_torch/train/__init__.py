"""Training: state and step factories.  Checkpointing, the fault policy,
chaos injection and recovery are a later slice (ROADMAP.md §1, the
substrate)."""

from repro_torch.train.state import make_train_state, param_count  # noqa
from repro_torch.train.step import (make_eval_step,  # noqa: F401
                                    make_pod_train_step, make_train_step)
