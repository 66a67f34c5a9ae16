"""Known-good corpus for RL-DETERMINISM (port): seeded, tick-driven,
sorted, explicit generators."""
import numpy as np
import torch


def jitter_backoff(attempt, seed):
    rng = np.random.default_rng(seed)    # explicit seed threads through
    return rng.uniform() * attempt


def now_tick(tick):
    return tick                          # time is the injected tick


def drain(pending):
    for item in sorted(pending):         # deterministic order
        handle(item)


def handle(item):
    return item


def poison(shape, seed):
    gen = torch.Generator().manual_seed(seed)    # this consumer's stream
    return torch.randn(shape, generator=gen)


def pick_victim(n, gen):
    return torch.randint(0, n, (1,), generator=gen)
