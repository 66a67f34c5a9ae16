"""Known-bad corpus for RL-DTYPE (port; opts into the core/moments.py
scope via its name): float64 reaching a moment accumulation."""
import numpy as np
import torch


def gram_accumulate(gram, update):
    return gram + update.to(torch.float64)            # .to(float64)


def widen(vty):
    return vty.double()                               # .double()


def zeros(k, device):
    return torch.zeros(k, k, dtype=torch.float64, device=device)


def weight(w):
    return torch.as_tensor(np.float64(w))             # f64 scalar tensor


def host_merge(parts):
    return sum(np.asarray(p, np.float64) for p in parts)   # numpy f64


def normalize(vty):
    return vty.astype(float)                          # Python float IS f64


def scale(count):
    return np.zeros(8, dtype=float)                   # dtype=float
