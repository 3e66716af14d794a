"""Runtime: supervised training with rollback, and pool-based recovery of
serving replicas."""
from repro_torch.runtime.fault_tolerance import (
    InjectedFailure,
    RecoveryEvent,
    ReplicaSet,
    SupervisorConfig,
    TrainSupervisor,
    on_devices_of,
    replay_disruption,
)

__all__ = ["InjectedFailure", "RecoveryEvent", "ReplicaSet", "SupervisorConfig",
           "TrainSupervisor", "on_devices_of", "replay_disruption"]
