"""Training substrate: state, step factories, verified-integrity
checkpoints, the fault policy and recovery orchestration, chaos injection.
The pod step and its error-feedback residual are the multi-device slice
(ROADMAP.md §1, item 6): ``make_pod_train_step`` raises."""

from repro_torch.train.state import (  # noqa: F401
    make_train_state, param_count, tree_signature,
)
from repro_torch.train.step import (  # noqa: F401
    make_eval_step, make_pod_train_step, make_train_step,
)
from repro_torch.train.checkpoint import (  # noqa: F401
    CheckpointCorruptError, latest_step, latest_valid_step,
    list_checkpoints, quarantine_checkpoint, restore_checkpoint,
    save_checkpoint, verify_checkpoint,
)
from repro_torch.train.fault import (  # noqa: F401
    RESUME_LATEST, FaultEventLog, FaultPolicy, StragglerDetector,
    run_with_recovery,
)
from repro_torch.train.chaos import (  # noqa: F401
    ChaosPreemption, ChaosSchedule, corrupt_checkpoint,
)
