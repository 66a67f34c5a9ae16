"""The port's checkpointer on the CPU: the six tests of
``tests/test_checkpoint.py`` (round trip, torn writes, missing and
mismatched checkpoints, GC, a train resume that replays the same losses),
its layout and key errors, and the train launcher's resume: a run broken
at a checkpoint and resumed gives the same losses as the run without a
break, also with ``--microbatches 2`` (where the reference resumes its
pipeline at ``last * microbatches`` and skips batches).  On the CPU the
replays are exact; the reference's bar is rtol 1e-5."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, configs
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import train as train_lib
from repro_torch.models import get_model
from repro_torch.train import (TrainConfig, abstract_train_state,
                               init_train_state, make_train_step)

torch.set_num_threads(1)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(0, 1, (4, 8)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(
            rng.normal(0, 1, (3,)).astype(np.float32)).to(torch.bfloat16),
            "c": torch.tensor(7, dtype=torch.int32)},
        "list": [torch.ones((2, 2)), torch.zeros((5,))],
    }


def _meta(tree):
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return [_meta(v) for v in tree]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in vals for leaf in _leaves(v)]


def test_roundtrip(tmp_path):
    tree = _tree()
    checkpoint.save(str(tmp_path), 10, tree)
    out = checkpoint.restore(str(tmp_path), 10, _meta(tree), device="cpu")
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert b.device.type == "cpu"
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert isinstance(out["list"], list)


def test_layout_is_npz_with_a_json_index(tmp_path):
    final = checkpoint.save(str(tmp_path), 3, _tree(), extra_metadata={"x": 1})
    assert sorted(os.listdir(final)) == [checkpoint.COMMIT_MARKER,
                                         "host_000.npz", "index.json"]
    with open(os.path.join(final, "index.json")) as f:
        index = json.load(f)
    assert index["step"] == 3 and index["extra"] == {"x": 1}
    keys = {m["key"]: m for m in index["keys"]}
    assert set(keys) == {"a", "nested/b", "nested/c", "list/0", "list/1"}
    assert keys["nested/b"]["dtype"] == "bfloat16"
    with np.load(os.path.join(final, "host_000.npz")) as data:
        assert data["nested/b"].dtype == np.uint16       # the bf16 bits


def test_latest_step_ignores_uncommitted(tmp_path):
    tree = _tree()
    checkpoint.save(str(tmp_path), 5, tree)
    checkpoint.save(str(tmp_path), 10, tree)
    # fake a torn write: committed marker missing
    torn = tmp_path / "step_00000015"
    shutil.copytree(tmp_path / "step_00000010", torn)
    os.remove(torn / checkpoint.COMMIT_MARKER)
    os.makedirs(tmp_path / "step_00000020.tmp")
    assert checkpoint.latest_step(str(tmp_path)) == 10
    assert checkpoint.latest_step(str(tmp_path / "none")) is None


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path), 1, _tree())


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    checkpoint.save(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path), 1, _meta(bad), device="cpu")
    extra = dict(_tree(), more=torch.zeros(3))
    with pytest.raises(KeyError):
        checkpoint.restore(str(tmp_path), 1, extra, device="cpu")


def test_gc_old(tmp_path):
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(str(tmp_path), s, _tree())
    os.makedirs(tmp_path / "step_00000006.tmp")
    checkpoint.gc_old(str(tmp_path), keep=2)
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["step_00000004", "step_00000005"]


def test_train_resume_bitwise(tmp_path):
    """save at step k, keep training to k+n; restart from the checkpoint
    into a state drawn from another seed (and into the abstract state) and
    replay: the losses match (deterministic pipeline + state restore)."""
    cfg = configs.get_smoke_config("internlm2-1.8b")
    model = get_model(cfg)
    step_fn = make_train_step(model, TrainConfig())
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)

    state = init_train_state(model, 0, device="cpu")
    pipe = TokenPipeline(dcfg, device="cpu")
    losses_a = []
    for step in range(6):
        if step == 3:
            checkpoint.save(str(tmp_path), 3, state)
        state, m = step_fn(state, pipe.next())
        losses_a.append(float(m["loss"]))

    for like in (init_train_state(model, 1, device="cpu"),   # wrong seed
                 abstract_train_state(model)):
        state_b = checkpoint.restore(str(tmp_path), 3, like, device="cpu")
        assert int(state_b["step"]) == int(state_b["opt"]["count"]) == 3
        pipe_b = TokenPipeline(dcfg, start_batch=3, device="cpu")
        losses_b = []
        for step in range(3, 6):
            state_b, m = step_fn(state_b, pipe_b.next())
            losses_b.append(float(m["loss"]))
        np.testing.assert_allclose(losses_b, losses_a[3:], rtol=1e-5)
        assert losses_b == losses_a[3:]                 # exact on the CPU
    for (n, p), (_, q) in zip(state["params"].named_parameters(),
                              state_b["params"].named_parameters()):
        assert torch.equal(p, q), n


def _launch(ckpt, *extra):
    return train_lib.run(["--smoke", "--device", "cpu", "--steps", "8",
                          "--global-batch", "4", "--seq-len", "32",
                          "--warmup", "2", "--ckpt-every", "4",
                          "--log-every", "100", "--ckpt-dir", str(ckpt),
                          *extra])


@pytest.mark.parametrize("microbatches", ["1", "2"])
def test_launcher_resume_equals_the_unbroken_run(tmp_path, microbatches):
    """The run of 8 steps checkpoints at 4 and 8; with step 8's checkpoint
    gone the launcher resumes at 4 and replays steps 4-7 with the same
    batches, so the same losses (the pipeline yields one global batch per
    step whatever the microbatch count)."""
    whole = _launch(tmp_path, "--microbatches", microbatches)
    assert whole["start_step"] == 0 and sorted(whole["losses"]) == \
        list(range(8))
    assert checkpoint.latest_step(str(tmp_path)) == 8
    shutil.rmtree(tmp_path / "step_00000008")
    resumed = _launch(tmp_path, "--microbatches", microbatches)
    assert resumed["start_step"] == 4
    assert resumed["losses"] == {s: whole["losses"][s] for s in range(4, 8)}
    assert resumed["losses"][7] < whole["losses"][0]
    for (n, p), (_, q) in zip(whole["state"]["params"].named_parameters(),
                              resumed["state"]["params"].named_parameters()):
        assert torch.equal(p, q), n


def test_launcher_vlm_batch_and_unported_options(tmp_path, capsys):
    out = train_lib.run(["--arch", "llava-next-mistral-7b", "--smoke",
                         "--device", "cpu", "--steps", "2", "--seq-len", "16",
                         "--global-batch", "2"])
    assert sorted(out["losses"]) == [0, 1]
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="step 5"):
        train_lib.run(["--smoke", "--device", "cpu", "--model-parallel", "2"])
    with pytest.raises(NotImplementedError, match="step 4"):
        train_lib.run(["--arch", "whisper-base", "--smoke", "--device",
                       "cpu"])
