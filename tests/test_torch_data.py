"""The port's data pipeline on the CPU: restart safety, host sharding,
the Zipf unigram and the Markov repeat against the reference pipeline's
own statistics, and ``curve_dataset`` bit-equal to the reference's.

The port draws on a ``torch.Generator``, the reference on ``jax.random``:
the two streams differ draw for draw, so the pipelines are held to each
other by their statistics (over 64 batches of 8 × 257 tokens, a share's
standard error is ≈ 0.002; the bars are 0.02), and parity tests of the
train step feed the same numpy batches to both packages."""
import jax
import numpy as np
import pytest
import torch

from repro.data import DataConfig as RDataConfig
from repro.data import TokenPipeline as RTokenPipeline
from repro.data import curve_dataset as rcurve_dataset
from repro_torch.data import DataConfig, TokenPipeline, curve_dataset

DCFG = DataConfig(vocab_size=1000, seq_len=256, global_batch=8, seed=3)


def _eq(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_batches_are_deterministic_and_restart_safe():
    a = TokenPipeline(DCFG, device="cpu")
    first = [a.next() for _ in range(5)]
    assert a.state() == {"batch_idx": 5}
    b = TokenPipeline(DCFG, start_batch=3, device="cpu")
    assert _eq(b.next(), first[3])
    b.restore({"batch_idx": 1})
    assert _eq(b.next(), first[1]) and _eq(b.next(), first[2])
    assert not _eq(first[0], first[1])
    batch = first[0]
    assert batch["tokens"].dtype == batch["labels"].dtype == torch.int32
    assert batch["tokens"].shape == batch["labels"].shape == (8, 256)
    assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    assert batch["loss_mask"].dtype == torch.float32
    assert bool((batch["loss_mask"] == 1).all())
    assert int(batch["tokens"].min()) >= 0
    assert int(batch["tokens"].max()) < DCFG.vocab_size
    other = TokenPipeline(DataConfig(1000, 256, 8, seed=4), device="cpu")
    assert not _eq(other.next(), first[0])


def test_host_shards_are_disjoint_and_deterministic():
    shards = [TokenPipeline(DCFG, host_id=h, n_hosts=4, device="cpu").next()
              for h in range(4)]
    again = TokenPipeline(DCFG, host_id=2, n_hosts=4, device="cpu").next()
    assert _eq(again, shards[2])
    rows = torch.cat([s["tokens"] for s in shards])
    assert rows.shape == (8, 256)
    assert len({tuple(r.tolist()) for r in rows}) == 8       # no row twice
    with pytest.raises(ValueError):
        TokenPipeline(DCFG, n_hosts=3, device="cpu")


def test_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TokenPipeline(DCFG)


def _stats(tokens, vocab):
    t = np.asarray(tokens).astype(np.int64)
    successor = np.mean(t[:, 1:] == (t[:, :-1] + 1) % vocab)
    counts = np.bincount(t.reshape(-1), minlength=vocab) / t.size
    return successor, counts


def test_zipf_draw_and_markov_repeat_match_the_reference():
    """A position repeats its predecessor's base token + 1 with p = 0.5:
    it is its predecessor's successor when it repeats and the predecessor
    did not (0.25), plus the Zipf draw's rarer coincidences; both
    pipelines show the same share, and the same unigram frequencies of
    the most frequent tokens."""
    port = TokenPipeline(DCFG, device="cpu")
    ref = RTokenPipeline(RDataConfig(vocab_size=1000, seq_len=256,
                                     global_batch=8, seed=3))
    pt = np.concatenate([port.next()["tokens"].numpy() for _ in range(64)])
    rt = np.concatenate([np.asarray(ref.next()["tokens"])
                         for _ in range(64)])
    ps, pc = _stats(pt, DCFG.vocab_size)
    rs, rc = _stats(rt, DCFG.vocab_size)
    assert 0.25 <= ps <= 0.32 and abs(ps - rs) <= 0.02
    np.testing.assert_allclose(pc[:8], rc[:8], atol=0.02)
    # Zipf's head (token 1 also takes token 0's repeats)
    assert pc[1] > pc[0] > pc[2] > pc[50]


@pytest.mark.parametrize("batch", [(), (3,), (2, 4)])
@pytest.mark.parametrize("degree", [1, 3])
def test_curve_dataset_is_bit_equal_to_the_reference(batch, degree):
    got = curve_dataset(500, degree=degree, noise=0.5, seed=7, batch=batch,
                        device="cpu")
    want = rcurve_dataset(500, degree=degree, noise=0.5, seed=7, batch=batch)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == batch + (500,)
    assert got[2].shape == batch + (degree + 1,)
