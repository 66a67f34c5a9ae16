"""Known-bad corpus for RL-SUPPRESS (port): the suppression policy."""
import torch


def sneaky(x):
    # reprolint: disable=RL-TRACERLEAK
    return x.item()              # reasonless disable does NOT suppress


def bogus():
    # reprolint: disable=RL-SMEM — a code the suite doesn't define
    return torch.zeros(1)
