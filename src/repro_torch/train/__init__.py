"""The training stack (port of ``repro.train``): AdamW, the train step,
gradient compression and the LSE training monitors."""
from repro_torch.train.optimizer import (AdamWConfig, init_state,
                                         apply_updates, schedule)
from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                          make_eval_step, init_train_state,
                                          abstract_train_state,
                                          train_state_specs, cross_entropy)
from repro_torch.train.monitors import LossCurveMonitor, StepTimeMonitor

__all__ = ["AdamWConfig", "TrainConfig", "make_train_step", "make_eval_step",
           "init_train_state", "abstract_train_state", "train_state_specs",
           "cross_entropy", "LossCurveMonitor", "StepTimeMonitor",
           "init_state", "apply_updates", "schedule"]
