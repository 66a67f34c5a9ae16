"""Known-good corpus for RL-DTYPE (port): every width named, f32 through
the accumulation; a dispatch table may name float64 as a key."""
import numpy as np
import torch

# a dtype as a dispatch-table key makes no value
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def gram_accumulate(gram, update):
    return gram + update.to(torch.float32)


def zeros(k, device):
    return torch.zeros(k, k, dtype=torch.float32, device=device)


def weight(w):
    return torch.as_tensor(np.float32(w), dtype=torch.float32)


def host_merge(parts):
    return sum(np.asarray(p, np.float32) for p in parts)


def code_of(x):
    if x.dtype == torch.float64:          # a comparison makes no value
        return _IN_CODES[x.dtype]
    return _IN_CODES[torch.float32]
