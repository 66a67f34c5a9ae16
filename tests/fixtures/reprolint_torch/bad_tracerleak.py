"""Known-bad corpus for RL-TRACERLEAK (port): host syncs in step- and
autograd-reachable code."""
import torch

from repro_torch.serve.fit_engine import StepFunction


def fit_step(state, x):
    if torch.any(torch.isnan(x)):         # Python if on a tensor
        return state
    return helper(state, x)


def helper(state, x):
    while torch.sum(x) > 0:               # Python while, step-reachable
        x = x - 1.0
    scale = float(torch.max(x))           # float() of a tensor
    print("scale", x)                     # print of a tensor
    return state * scale + x.sum().item()   # .item()


step = StepFunction(fit_step)


class Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.bound = x.abs().max().cpu()   # host copy in the forward
        return x.clamp(-1.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        return g * (g.abs() < ctx.bound).to(g.dtype)
