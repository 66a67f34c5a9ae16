"""Deterministic, per-host-sharded synthetic data pipeline (port of
``repro.data.pipeline``).

Every host generates only its own shard of each global batch from a seeded
counter (no cross-host I/O): batch ``i``, host ``h`` draws its examples
from a ``torch.Generator`` seeded from ``(seed, i · n_hosts + h)``.
Restart-safe (the batch index is part of the checkpoint) and elastic-safe
(resharding only changes the host→example map, not the example stream).

Token streams follow a Zipfian unigram draw with a Markov repeat, so
models actually learn (loss decreases) in the end-to-end examples.  The
draws are the reference's distributions on torch's generator, made on the
CPU and then moved to the device (so a batch is the same on every
device); they are not the reference's ``jax.random`` stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenPipeline:
    """Batches of {'tokens','labels','loss_mask'} for one host, on
    ``device`` (``None`` means CUDA)."""

    def __init__(self, dcfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                 start_batch: int = 0, device=None):
        if dcfg.global_batch % n_hosts:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.dcfg = dcfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.batch_idx = start_batch
        self.local_batch = dcfg.global_batch // n_hosts
        self.device = resolve_device(device)
        # Zipf-ish unigram over vocab, fixed by seed
        ranks = np.arange(1, dcfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-dcfg.zipf_a)
        self._probs = torch.from_numpy(probs / probs.sum())

    def _rng(self) -> torch.Generator:
        counter = self.batch_idx * self.n_hosts + self.host_id
        seed = np.random.SeedSequence([self.dcfg.seed, counter])
        return torch.Generator().manual_seed(
            int(seed.generate_state(1, np.uint64)[0]))

    def next(self):
        d = self.dcfg
        g = self._rng()
        shape = (self.local_batch, d.seq_len + 1)
        base = torch.multinomial(self._probs, shape[0] * shape[1],
                                 replacement=True, generator=g).reshape(shape)
        # Markov structure: with p=0.5 the next token repeats (t + 1) mod V
        rep = torch.rand(shape, generator=g) < 0.5
        toks = torch.where(
            rep, torch.roll((base + 1) % d.vocab_size, 1, dims=1), base)
        toks = toks.to(torch.int32)
        self.batch_idx += 1
        return {
            "tokens": toks[:, :-1].contiguous().to(self.device),
            "labels": toks[:, 1:].contiguous().to(self.device),
            "loss_mask": torch.ones((self.local_batch, d.seq_len),
                                    dtype=torch.float32, device=self.device),
        }

    def state(self) -> dict:
        return {"batch_idx": self.batch_idx}

    def restore(self, state: dict) -> None:
        self.batch_idx = int(state["batch_idx"])


def curve_dataset(n: int, degree: int = 3, noise: float = 1.0,
                  seed: int = 0, batch: tuple[int, ...] = (), device=None):
    """Synthetic polynomial datasets for the paper's own workload: returns
    (x, y, true_coeffs) as float32 tensors on ``device``.  x ~ U[-10, 10];
    y = poly(x) + N(0, noise), drawn in float64 numpy as the reference."""
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(0, 1, batch + (degree + 1,))
    x = rng.uniform(-10, 10, batch + (n,))
    powers = np.stack([x ** k for k in range(degree + 1)], axis=-1)
    y = np.einsum("...nk,...k->...n", powers, coeffs)
    y = y + rng.normal(0, noise, y.shape)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (x, y, coeffs))
