"""Serving: continuous-batching engine, decode-state surgery, fleet scheduler."""
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine
from repro_torch.serving.scheduler import FleetScheduler, SchedulerConfig
from repro_torch.serving.state_utils import state_extract, state_reset_slot, state_splice

__all__ = [
    "Request", "ServeConfig", "ServingEngine",
    "FleetScheduler", "SchedulerConfig",
    "state_extract", "state_reset_slot", "state_splice",
]
