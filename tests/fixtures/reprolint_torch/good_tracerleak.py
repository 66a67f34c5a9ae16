"""Known-good corpus for RL-TRACERLEAK (port): the step's control flow
stays on the card."""
import torch

from repro_torch.serve.fit_engine import StepFunction


def fit_step(state, x):
    ok = torch.logical_not(torch.any(torch.isnan(x)))
    return torch.where(ok, helper(state, x), state)


def helper(state, x):
    total = torch.sum(x)
    if x.dtype == torch.float64:          # a static attribute, no sync
        total = total.to(torch.float32)
    return state + torch.where(total > 0, total, torch.zeros_like(total))


step = StepFunction(fit_step)


def report(state):
    # not step-reachable: the host may read results after the step
    print("final", float(torch.max(state)))


class Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clamp(-1.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        return g
