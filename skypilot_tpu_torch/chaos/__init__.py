"""Deterministic fault injection, the core of the reference's chaos
subsystem (`skypilot_tpu/chaos/`): the fault-plan format (`faults`) and
the process-global injector (`injector`).  The reference's scenarios,
invariant checkers and elastic task are not copied; its invariant
checkers read the journals the port writes."""
from skypilot_tpu_torch.chaos.faults import ChaosError
from skypilot_tpu_torch.chaos.faults import Fault
from skypilot_tpu_torch.chaos.faults import FaultPlan
from skypilot_tpu_torch.chaos.faults import SITES
from skypilot_tpu_torch.chaos.injector import DENY
from skypilot_tpu_torch.chaos.injector import arm
from skypilot_tpu_torch.chaos.injector import disarm
from skypilot_tpu_torch.chaos.injector import inject
from skypilot_tpu_torch.chaos.injector import site_armed

__all__ = [
    'ChaosError', 'Fault', 'FaultPlan', 'SITES', 'DENY', 'arm', 'disarm',
    'inject', 'site_armed',
]
