"""The one place an entry point's ``device=`` argument is resolved."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Without CUDA only an explicit CPU request runs:
    there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; repro_torch entry points run on the GPU "
            "by default — pass device='cpu' to run the plain PyTorch path")
    return dev


def as_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Tensor on ``device`` (numpy arrays and lists accepted)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    t = torch.as_tensor(a, dtype=dtype)
    return t.to(device)
