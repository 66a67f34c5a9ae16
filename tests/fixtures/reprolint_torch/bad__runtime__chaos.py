"""Known-bad corpus for RL-DETERMINISM (port; opts into the
runtime/chaos.py scope via its name): wall clock, unseeded and global
RNG (numpy and torch), set-iteration order."""
import time

import numpy as np
import torch


def jitter_backoff(attempt):
    rng = np.random.default_rng()        # unseeded: OS entropy
    return rng.uniform() * attempt


def now_tick():
    return time.time()                   # wall clock in the tick domain


def drain(pending):
    for item in set(pending):            # hash-order iteration
        handle(item)


def handle(item):
    return item


def poison(shape):
    torch.manual_seed(0)                 # reseeds the process-wide stream
    return torch.randn(shape)            # global stream, no generator=


def pick_victim(n):
    return torch.randint(0, n, (1,))     # global stream, no generator=
