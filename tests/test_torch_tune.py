"""The ring kernel's block-size tuner (``repro_torch.kernels.tune``, port of
``repro.kernels.tune``): the shared-memory budget model and the cached
one-shot sweep.  On the CPU the sweep runs the ring's plain version and
is timed by a fake clock, so these tests check the model, the candidate
filter, the winner and the cache, not a time."""
import itertools

import pytest
import torch

from repro_torch.kernels import moments as K
from repro_torch.kernels import tune

torch.set_num_threads(1)


@pytest.mark.parametrize("degree", [1, 3, 14, 15, 40, 62])
def test_budget_model_is_monotone(degree):
    def size(bn, nbuf, weighted, itemsize=4):
        return tune.ring_smem_bytes(degree, bn, nbuf=nbuf, itemsize=itemsize,
                                    weighted=weighted)
    for nbuf, weighted in itertools.product((2, 3, 4), (False, True)):
        sizes = [size(bn, nbuf, weighted) for bn in tune.CANDIDATE_BLOCKS]
        assert sizes == sorted(sizes) and len(set(sizes)) == len(sizes)
    for bn in tune.CANDIDATE_BLOCKS:
        assert size(bn, 2, False) < size(bn, 3, False) < size(bn, 4, False)
        assert size(bn, 2, False) < size(bn, 2, True)
        assert size(bn, 2, False, itemsize=2) < size(bn, 2, False)
        assert size(bn, 2, False) == tune.ring_smem_bytes(
            degree, bn, compensated=True)


def test_budget_model_values():
    # eight warps' rings at degree <= 14: (4·1024 + 4, 16-byte rounded) × 2
    # arrays × 2 slots × 8 = 131584 bytes
    assert tune.ring_smem_bytes(3, 1024) == 8 * 2 * 2 * 4112
    assert tune.ring_smem_bytes(3, 1024, weighted=True) == 8 * 2 * 3 * 4112
    # one CTA per task above degree 14, plus the static tile
    tile = (K.TILE_POINTS * (K.MAX_POWERS + 1) + K.TILE_POINTS) * 4
    assert tune.ring_smem_bytes(20, 1024) == 2 * 2 * 4112 + tile
    assert tune.feasible_blocks(3) == (128, 256, 512, 1024)
    assert tune.feasible_blocks(3, nbuf=4) == (128, 256, 512)
    assert tune.feasible_blocks(20, nbuf=4) == tune.CANDIDATE_BLOCKS
    assert tune.feasible_blocks(3, nbuf=200) == ()
    assert "VMEM_BUDGET" not in vars(tune)


def test_budget_off_the_card_is_the_planning_constant():
    assert tune.smem_budget("cpu") == tune.SMEM_BUDGET == 227 * 1024
    assert tune.feasible_blocks(3, budget=tune.smem_budget("cpu")) == \
        tune.feasible_blocks(3)
    # a smaller card budget drops the blocks that no longer fit
    assert tune.feasible_blocks(3, budget=64 * 1024) == (128, 256)


@pytest.mark.parametrize("degree,nbuf,weighted,itemsize", [
    (3, 2, False, 4), (3, 3, True, 4), (7, 4, True, 2), (14, 2, True, 8),
    (20, 4, True, 4), (62, 8, False, 2)])
def test_every_feasible_block_fits_the_budget(degree, nbuf, weighted,
                                              itemsize):
    blocks = tune.feasible_blocks(degree, nbuf=nbuf, itemsize=itemsize,
                                  weighted=weighted)
    assert blocks
    for bn in blocks:
        assert bn % 32 == 0
        assert tune.ring_smem_bytes(degree, bn, nbuf=nbuf, itemsize=itemsize,
                                    weighted=weighted) <= tune.SMEM_BUDGET
    for bn in set(tune.CANDIDATE_BLOCKS) - set(blocks):
        assert tune.ring_smem_bytes(degree, bn, nbuf=nbuf, itemsize=itemsize,
                                    weighted=weighted) > tune.SMEM_BUDGET


class FakeClock:
    """A host clock that makes block 256 the fastest: each run of the
    sweep advances time by a cost read from the block the sweep is on."""

    def __init__(self):
        self.t = 0.0
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return self.t


def test_sweep_picks_the_fastest_and_caches(monkeypatch):
    tune.clear_cache()
    clock = FakeClock()
    cost = {128: 3.0, 256: 1.0, 512: 2.0, 1024: 4.0}
    seen = []
    real = K.moments_packed_ring

    def timed_ring(x, y, w=None, *, block_n, **kw):
        seen.append(block_n)
        clock.t += cost[block_n]
        return real(x, y, w, block_n=block_n, **kw)

    monkeypatch.setattr(K, "moments_packed_ring", timed_ring)
    bn = tune.autotune_block_n(3, 256, device="cpu", timer=clock)
    assert bn == 256
    assert set(seen) == set(tune.feasible_blocks(3))
    times = tune.sweep_times()[(3, "float32", "cpu", 2, False)]
    assert times == {b: cost[b] * 1e3 for b in cost}
    calls = clock.calls
    assert tune.autotune_block_n(3, 256, device="cpu", timer=clock) == 256
    assert clock.calls == calls and len(seen) == 3 * 4   # a dict hit
    # nbuf and weighted are part of the key: a new sweep each
    tune.autotune_block_n(3, 256, nbuf=4, device="cpu", timer=clock)
    tune.autotune_block_n(3, 256, weighted=True, device="cpu", timer=clock)
    assert len(tune.sweep_times()) == 3
    assert len(seen) == 3 * 4 + 3 * 3 + 3 * 4
    tune.clear_cache()
    assert tune.sweep_times() == {}


def test_sweep_needs_a_clock_off_the_card_and_a_feasible_block():
    tune.clear_cache()
    with pytest.raises(ValueError, match="CUDA events"):
        tune.autotune_block_n(3, 256, device="cpu")
    with pytest.raises(ValueError, match="no ring block"):
        tune.autotune_block_n(3, 256, nbuf=200, device="cpu",
                              timer=FakeClock())
