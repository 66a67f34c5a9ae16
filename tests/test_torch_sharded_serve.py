"""Sharded serving on 4 gloo CPU ranks against the unsharded model.

One group of ranks (``tests/_torch_sharded_ranks.py`` rank serve ...)
runs each case of ``SERVE_CASES`` at float32 compute: the serving
parameters laid out by the case's rule overrides (as the dry run lays out
a decode cell's), a prefill under the train rules whose cache
``constrain_state`` lays out by the overrides, then 4 decode steps of
fixed tokens.  Held here against the same prefill and steps without a
mesh, within 15a's 1e-4 (of each step's largest logit):

* internlm2 (4 q heads, 2 kv heads) on (1, 4) under the decode rules: q
  split by heads, the cache by head_dim (partial logits all-reduced);
* qwen1.5 with 2 heads and 2 kv heads on (1, 4): q replicated, the cache
  split by head_dim, as qwen's 20 heads are on 16;
* zamba2 at batch 1 on (2, 2) under the long-context rules: the cache
  split over kv_seq in 4 blocks of 8, the last fully masked at every
  step (the flash-decoding combine must add nothing from it, and no NaN);
  once with a 20-token prompt and once with 16, one whole Mamba chunk
  (the prefill's decay arrives split along the sequence there, and
  ``chunked_gla`` must take it whole before its cumsum).

The cache keeps its split through the steps, and the last decode step
books no collective at ``attention.py:_on_local_blocks`` (no cache
gather); the in-place cache writes move only the new rows.  Beside the
ranks: each rank's block of q heads against the kv heads it reads equals
that block of the whole attention (no mesh).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "_torch_sharded_ranks", ROOT / "tests" / "_torch_sharded_ranks.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
_spec = importlib.util.spec_from_file_location(
    "test_torch_sharded_train", ROOT / "tests" / "test_torch_sharded_train.py")
T = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(T)

TOL = 1e-4            # phase 15a's rule
torch.set_num_threads(1)
CASES = {c[0]: c for c in R.SERVE_CASES}
# the tensor dim each case's cache (layers, b, skv, kh, hd) is split over
SPLIT = {"internlm2": "Shard(dim=4)", "qwen1.5-2h": "Shard(dim=4)",
         "zamba2-long": "Shard(dim=2)", "zamba2-chunk": "Shard(dim=2)"}


@pytest.fixture(scope="module")
def serve_ranks():
    return T.run_ranks("serve")


def _unsharded(case):
    cfg = R.serve_config(case)
    model = get_model(cfg)
    cp = model.compute_params(model.init_params(R.SEED, device="cpu"))
    toks = torch.from_numpy(R.serve_tokens(case))
    out = {}
    with torch.no_grad():
        logits, state = model.prefill(
            cp, {"tokens": torch.from_numpy(R.serve_prompt(case))},
            case[-1])
        out["prefill"] = logits.float().numpy()
        for i in range(R.SERVE_STEPS):
            logits, state = model.decode_step(cp, toks[:, i:i + 1], state)
            out[f"step{i}"] = logits.float().numpy()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_and_decode_equal_the_unsharded_model(serve_ranks,
                                                              name):
    want = _unsharded(CASES[name])
    for key, w in want.items():
        got = serve_ranks[f"{name}/{key}"]
        assert got.shape == w.shape, (name, key)
        assert np.isfinite(got).all(), (name, key)
        err = np.abs(got - w).max()
        assert err <= TOL * np.abs(w).max(), (name, key, err)


@pytest.mark.parametrize("name", list(CASES))
def test_the_cache_stays_split_and_is_never_gathered(serve_ranks, name):
    assert SPLIT[name] in list(serve_ranks[f"{name}/cache_placements"])
    sites = json.loads(str(serve_ranks[f"{name}/sites"]))
    assert sites.get("attention.py:_on_local_blocks", 0.0) == 0.0, sites
    # the in-place writes move no block of the cache: on a head_dim split
    # nothing at all, on a kv_seq split the new rows alone, gathered whole
    # for the rank that owns their position (an all-gather's bytes are its
    # result's: b·kh·hd float32 for k and v in each attention layer)
    cfg = R.serve_config(CASES[name])
    want = 0.0
    if name.startswith("zamba2"):
        from repro_torch.models.zamba2 import n_groups
        b = CASES[name][5]
        want = (R.SERVE_STEPS * 2 * n_groups(cfg)
                * b * cfg.n_kv_heads * cfg.resolved_head_dim * 4)
    assert float(serve_ranks[f"{name}/write_bytes"]) == want


@pytest.mark.parametrize("h,kh,ranks", [(4, 2, 4), (16, 8, 16), (6, 2, 3),
                                        (20, 4, 10), (12, 2, 4)])
def test_q_head_blocks_read_their_kv_heads(h, kh, ranks):
    """Attention on q-head blocks where the kv heads do not divide the
    ranks: each rank's block of q heads against the kv heads
    ``attention._kv_heads_of`` gives it (one kv head where the block falls
    in one group, as internlm2's 16 q heads on 16; one per q head where it
    straddles two, as 20 q heads and 4 kv heads on 10) equals that block
    of the whole attention."""
    from repro_torch.models import attention as attn
    cfg = attn.AttnConfig(d_model=8, n_heads=h, n_kv_heads=kh, head_dim=8)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 5, n, 8, generator=g) for n in (h, kh, kh))
    mask = attn.causal_mask(5, 5)
    whole = attn._sdpa(cfg, q, k, v, mask)
    n = h // ranks
    for r in range(ranks):
        heads = (r * n, (r + 1) * n)
        kl, vl = attn._kv_heads_of(heads, h // kh, k, v)
        got = attn._sdpa(cfg, q[:, :, heads[0]:heads[1]], kl, vl, mask)
        torch.testing.assert_close(got, whole[:, :, heads[0]:heads[1]],
                                   rtol=1e-6, atol=1e-6)
