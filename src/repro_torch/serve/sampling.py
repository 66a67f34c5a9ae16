"""Token sampling: greedy / temperature / top-k (port of
``repro.serve.sampling``), drawn from a ``torch.Generator``."""
from __future__ import annotations

import torch


def sample(logits, temperature, generator=None, top_k: int | None = None):
    """logits: (B, V) -> (B,) int64.  ``temperature`` is one float or one
    per row; a row at temperature <= 0 takes its argmax (the first maximum,
    as ``jnp.argmax``), the others draw from softmax(logits / T) with
    ``generator`` after an optional top-k cut."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    temps = torch.as_tensor(temperature, dtype=torch.float32)
    if temps.ndim == 0:
        temps = temps.expand(logits.shape[0])
    hot = (temps > 0).tolist()
    if not any(hot):
        return greedy
    rows = torch.tensor([i for i, h in enumerate(hot) if h],
                        device=logits.device)
    scaled = logits[rows] / temps.to(logits.device)[rows, None]
    if top_k:
        cutoff = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    drawn = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                              generator=generator)[:, 0]
    return greedy.index_copy(0, rows, drawn)
