"""Training monitors on the streaming LSE core (the monitors of
``repro.train``; the rest of the training stack is not ported yet)."""
from repro_torch.train.monitors import LossCurveMonitor, StepTimeMonitor

__all__ = ["LossCurveMonitor", "StepTimeMonitor"]
