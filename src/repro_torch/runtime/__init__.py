"""Runtime: pool-based recovery of serving replicas."""
from repro_torch.runtime.fault_tolerance import RecoveryEvent, ReplicaSet, replay_disruption

__all__ = ["RecoveryEvent", "ReplicaSet", "replay_disruption"]
