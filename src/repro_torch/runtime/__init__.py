"""Fault-tolerance runtime on the virtual tick clock (port of
``repro.runtime``): chaos injection, heartbeats, restarts, the fitted
straggler detector and reslice plans."""
from repro_torch.runtime.chaos import (FAULT_KINDS, ChaosSchedule,
                                       ChaosWorker, FaultEvent)
from repro_torch.runtime.fault_tolerance import (HeartbeatTracker,
                                                 RestartPolicy, ElasticPlan,
                                                 FailureDetector)
from repro_torch.runtime.straggler import plan_reslice, ResliceAction

__all__ = ["HeartbeatTracker", "RestartPolicy", "ElasticPlan",
           "FailureDetector", "plan_reslice", "ResliceAction",
           "FAULT_KINDS", "ChaosSchedule", "ChaosWorker", "FaultEvent"]
