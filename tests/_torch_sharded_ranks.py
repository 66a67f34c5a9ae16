"""The multi-rank sides of ``tests/test_torch_sharding.py`` and
``tests/test_torch_sharded_train.py``.

    python tests/_torch_sharded_ranks.py indices OUT.json
    python tests/_torch_sharded_ranks.py rank GROUP RANK WORLD STORE OUT.npz

``indices`` runs the JAX reference on 4 host devices (the caller sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4``): for each case of
``PLACEMENT_CASES``, the block of the global array that
``NamedSharding(make_mesh((2, 2)), P(*spec)).devices_indices_map`` gives
the device at each mesh position, keyed by that position's rank
(``row * 2 + column``).

``rank`` is one of 4 gloo ranks of the port (``FileStore`` at STORE)
running one GROUP of checks; rank 0 writes OUT.npz:

* ``placements``: each case's ``distribute_tensor`` block of an arange
  on the (2, 2) mesh, every rank's (gathered to rank 0);
* ``train``: one train step of each family's smoke config (float32
  compute) on meshes (4, 1), (2, 2) and (1, 4), from
  ``init_train_state(model, SEED, mesh=)`` and ``shard_batch`` of
  ``batch(cfg)``: loss, grad_norm, the whole parameters and mu after it;
  before it, each rank's blocks of the initial state against the
  single-process state's, and the bytes the call held at its peak;
* ``launcher``: ``repro_torch.launch.train.run`` with ``--model-parallel
  2`` for ``LAUNCH_STEPS`` steps (float32 compute): its losses;
* ``resume``: internlm2's smoke state trained 2 steps on (4, 1), saved,
  one more step (the unbroken run), then restored onto (2, 2) through
  ``tree_shardings`` and stepped again from the saved state;
* ``serve``: each case of ``SERVE_CASES`` (float32 compute) with its
  serving parameters laid out as the dry run lays them out (the case's
  rule overrides), a prefill of ``serve_prompt(case)`` under the train
  rules whose cache ``constrain_state`` lays out by the overrides, then
  ``SERVE_STEPS`` decode steps of ``serve_tokens(case)``: every step's
  logits, the cache's placements and the decode's collective bytes by
  ``constrain`` site (``roofline.CostCounter``).

The port's side imports neither jax nor ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
from datetime import timedelta

import numpy as np

WORLD = 4
SEED = 0
TRAIN_ARCHS = ["internlm2-1.8b", "phi3.5-moe-42b-a6.6b",
               "llava-next-mistral-7b", "rwkv6-1.6b", "zamba2-7b",
               "whisper-base", "qwen1.5-4b"]
# qwen1.5's smoke config with 2 heads: on (1, 4) they do not divide the
# model axis, so its attention runs on query-sequence blocks
# (attn_seq_shard), the layout its 20 heads take on 16 × 16
VARIANTS = {"qwen1.5-4b": dict(n_heads=2, n_kv_heads=2)}
MESHES = [(4, 1), (2, 2), (1, 4)]
FAMILY_CHUNK = 16          # the recurrent families' chunk (two per batch)
LAUNCH_STEPS = 5
LAUNCH_ARGS = ["--smoke", "--device", "cpu", "--steps", str(LAUNCH_STEPS),
               "--log-every", "100", "--global-batch", "8",
               "--seq-len", "32"]
RESUME_ARCH = "internlm2-1.8b"
# sharded serving: (name, arch, config changes, mesh, overrides, batch,
# prompt length, cache length).  internlm2's 4 q heads divide the 4-way
# model axis and its 2 kv heads do not: q heads split, cache head_dim
# split.  qwen1.5 with 2 heads: q replicated and the cache head_dim split,
# as its 20 heads are on 16.  zamba2 at batch 1 on (2, 2): the
# long-context rules split kv_seq over 4 ranks in blocks of 8; 20 prompt
# tokens and 4 steps leave the last block fully masked throughout and
# write the steps' rows into the third block alone.  A prompt of 16 tokens
# is one whole Mamba chunk: its prefill takes chunked_gla's unpadded path
SERVE_CASES = [
    ("internlm2", "internlm2-1.8b", {}, (1, 4), "decode", 4, 12, 24),
    ("qwen1.5-2h", "qwen1.5-4b", dict(n_heads=2, n_kv_heads=2), (1, 4),
     "decode", 4, 12, 24),
    ("zamba2-long", "zamba2-7b", {}, (2, 2), "long", 1, 20, 32),
    ("zamba2-chunk", "zamba2-7b", {}, (2, 2), "long", 1, 16, 32),
]
SERVE_STEPS = 4


def serve_config(case):
    from repro_torch import configs
    _, arch, changes, *_ = case
    return dataclasses.replace(f32_of(configs.get_smoke_config(arch)),
                               **changes)


def serve_prompt(case):
    cfg, (*_, b, s, _) = serve_config(case), case
    r = np.random.default_rng(20)
    return r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def serve_tokens(case):
    """The decode steps' tokens (b, SERVE_STEPS), fixed in advance so that
    both runs decode the same ones."""
    cfg, (*_, b, _, _) = serve_config(case), case
    r = np.random.default_rng(21)
    return r.integers(0, cfg.vocab_size, (b, SERVE_STEPS)).astype(np.int32)


# (shape, spec) on the (2, 2) ("data", "model") mesh
PLACEMENT_CASES = [
    ((8, 6, 4), ("data", "model", None)),
    ((8, 6, 4), ("model", None, "data")),
    ((8, 6, 4), (("data", "model"), None, None)),
    ((8, 6, 4), (None, None, ("data", "model"))),
    ((8, 6, 4), (None, "data", None)),
    ((8, 6), (None, None)),
]


def f32_of(cfg):
    """``cfg`` at float32 compute (and the recurrent families' chunk)."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.family in ("ssm", "hybrid", "audio"):
        cfg = dataclasses.replace(cfg, ssm_chunk=FAMILY_CHUNK)
    return cfg


def f32_config(arch):
    """The smoke config of ``arch`` at float32 compute (``VARIANTS``
    applied)."""
    from repro_torch import configs
    return dataclasses.replace(f32_of(configs.get_smoke_config(arch)),
                               **VARIANTS.get(arch, {}))


def f32_smoke_getter(configs):
    """A ``get_smoke_config`` giving the float32 configs, for the launcher
    to read in place of ``configs.get_smoke_config``."""
    orig = configs.get_smoke_config
    return lambda arch: f32_of(orig(arch))


def batch(cfg, b=8, s=32, seed=1):
    """A global batch of numpy arrays (llava: image embeddings before the
    text; whisper: 48 frames and the tokens as the decoder's)."""
    r = np.random.default_rng(seed)
    st = s + cfg.n_image_tokens
    out = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": r.integers(0, cfg.vocab_size, (b, st)).astype(np.int32),
           "loss_mask": (r.random((b, st)) > 0.2).astype(np.float32)}
    if cfg.n_image_tokens:
        out["extra_embeds"] = r.normal(
            0, 1, (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["dec_tokens"] = out.pop("tokens")
        out["frames"] = r.normal(0, 1, (b, 48, cfg.d_model)).astype(
            np.float32)
    return out


def tensors(arrays):
    import torch
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def indices(path):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for i, (shape, spec) in enumerate(PLACEMENT_CASES):
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        by_rank = {}
        for row in range(2):
            for col in range(2):
                sl = idx[mesh.devices[row, col]]
                by_rank[row * 2 + col] = [
                    [s.start or 0, shape[d] if s.stop is None else s.stop]
                    for d, s in enumerate(sl)]
        out[str(i)] = by_rank
    with open(path, "w") as f:
        json.dump(out, f)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _np(t):
    """A copy (a replicated DTensor's ``full_tensor`` is its own storage,
    which the next in-place step overwrites)."""
    return _full(t).detach().float().numpy().copy()


def _placements(out):
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import NamedSharding
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device_type="cpu")
    for i, (shape, spec) in enumerate(PLACEMENT_CASES):
        t = torch.arange(int(np.prod(shape)), dtype=torch.float32)
        local = NamedSharding(mesh, spec).distribute(
            t.reshape(shape)).to_local().contiguous()
        blocks = [None] * WORLD
        dist.all_gather_object(blocks, local.numpy())
        for r, blk in enumerate(blocks):
            out[f"{i}/{r}"] = blk


def _init_on_mesh(model, mesh):
    """``init_train_state(model, SEED, mesh=)`` on this rank, probed.
    Returns the state and, from every rank (gathered), ``equal``: its
    blocks of the parameters, mu and nu, and its count and step, are
    bit-equal to the single-process state's blocks as torch's
    ``distribute_tensor`` cuts them, in ``state_shardings``' placements;
    ``peak``: the most bytes live at once during the call
    (``CostCounter``'s eager-order peak); ``state``: the rank's state
    bytes; ``leaf``: the same peak of drawing the largest leaf whole
    alone (``dense_init``, its temporaries included)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import roofline as roof
    from repro_torch.models import common as cm
    from repro_torch.train import init_train_state
    from repro_torch.train.train_step import state_shardings
    counter = roof.CostCounter(track_memory=True)
    with counter:
        state = init_train_state(model, SEED, device="cpu", mesh=mesh)
    whole = init_train_state(model, SEED, device="cpu")
    sh = state_shardings(model, mesh)

    def same(got, want, sharding):
        block = distribute_tensor(want.detach(), mesh, sharding.placements,
                                  src_data_rank=None).to_local()
        return (tuple(got.placements) == tuple(sharding.placements)
                and torch.equal(got.to_local(), block))

    equal = all(
        same(tree[n], ref[n], sh_tree[n])
        for tree, ref, sh_tree in (
            (dict(state["params"].named_parameters()),
             dict(whole["params"].named_parameters()), sh["params"]),
            (state["opt"]["mu"], whole["opt"]["mu"], sh["opt"]["mu"]),
            (state["opt"]["nu"], whole["opt"]["nu"], sh["opt"]["nu"]))
        for n in ref)
    equal = (equal and same(state["opt"]["count"], whole["opt"]["count"],
                            sh["opt"]["count"])
             and same(state["step"], whole["step"], sh["step"]))
    leaves = (list(state["params"].parameters())
              + list(state["opt"]["mu"].values())
              + list(state["opt"]["nu"].values())
              + [state["opt"]["count"], state["step"]])
    nbytes = sum(t.to_local().numel() * t.element_size() for t in leaves)
    big = max(model.abstract_params().parameters(), key=lambda p: p.numel())
    draw = roof.CostCounter(track_memory=True)
    with draw:
        cm.dense_init(tuple(big.shape),
                      generator=torch.Generator().manual_seed(SEED))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (equal, counter.peak_bytes, nbytes,
                                 draw.peak_bytes))
    init = {k: np.asarray([g[i] for g in got])
            for i, k in enumerate(("equal", "peak", "state", "leaf"))}
    return state, init


def _train(out):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.train_step import shard_batch
    for shape in MESHES:
        mesh = mesh_lib.make_host_mesh(data=shape[0], model=shape[1],
                                       device_type="cpu")
        tag = f"{shape[0]}x{shape[1]}"
        for arch in TRAIN_ARCHS:
            cfg = f32_config(arch)
            model = get_model(cfg)
            state, init = _init_on_mesh(model, mesh)
            placed = all(type(p).__name__ == "DTensor"
                         for p in state["params"].parameters())
            state, m = make_train_step(model, TrainConfig())(
                state, shard_batch(tensors(batch(cfg)), mesh))
            key = f"{arch}/{tag}"
            for k, v in init.items():
                out[f"{key}/init_{k}"] = v
            out[f"{key}/all_dtensor"] = np.asarray(placed)
            out[f"{key}/loss"] = _np(m["loss"])
            out[f"{key}/grad_norm"] = _np(m["grad_norm"])
            for n, p in state["params"].named_parameters():
                out[f"{key}/p/{n}"] = _np(p)
                out[f"{key}/mu/{n}"] = _np(state["opt"]["mu"][n])


def _launcher(out):
    from repro_torch import configs
    from repro_torch.launch import train as train_lib
    configs.get_smoke_config = f32_smoke_getter(configs)
    run = train_lib.run(LAUNCH_ARGS + ["--model-parallel", "2"])
    out["mesh"] = np.asarray(tuple(run["mesh"].shape))
    out["losses"] = np.asarray([run["losses"][s]
                                for s in sorted(run["losses"])])


def _resume(out, ckpt):
    import torch.distributed as dist
    from repro_torch import checkpoint
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model
    from repro_torch.train import TrainConfig, init_train_state, \
        make_train_step
    from repro_torch.train.train_step import shard_batch, state_shardings
    cfg = f32_config(RESUME_ARCH)
    model = get_model(cfg)
    step = make_train_step(model, TrainConfig())
    batches = [tensors(batch(cfg, seed=10 + i)) for i in range(3)]
    m41 = mesh_lib.make_host_mesh(data=4, model=1, device_type="cpu")
    state = init_train_state(model, SEED, device="cpu", mesh=m41)
    for i in range(2):
        state, _ = step(state, shard_batch(batches[i], m41))
    checkpoint.save(ckpt, 2, state)
    saved = {n: _np(p) for n, p in state["params"].named_parameters()}
    state, m = step(state, shard_batch(batches[2], m41))
    out["unbroken/loss"] = _np(m["loss"])
    for n, p in state["params"].named_parameters():
        out[f"unbroken/p/{n}"] = _np(p)
    m22 = mesh_lib.make_host_mesh(data=2, model=2, device_type="cpu")
    like = init_train_state(model, SEED + 1, device="cpu", mesh=m22)
    state = checkpoint.restore(ckpt, 2, like,
                               shardings=state_shardings(model, m22, like))
    out["restored_mesh"] = np.asarray(tuple(
        state["params"].embed.table.device_mesh.shape))
    out["restored_equal"] = np.asarray(all(
        np.array_equal(_np(p), saved[n])
        for n, p in state["params"].named_parameters()))
    out["restored_step"] = _np(state["step"])
    state, m = step(state, shard_batch(batches[2], m22))
    out["resumed/loss"] = _np(m["loss"])
    for n, p in state["params"].named_parameters():
        out[f"resumed/p/{n}"] = _np(p)
    dist.barrier()


def _serve(out):
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline as roof
    from repro_torch.models import attention
    from repro_torch.models import get_model
    from repro_torch.sharding import rules
    from repro_torch.train.train_step import shard_batch
    # the bytes booked while the cache is written in place (any site)
    counter, written = None, [0.0]
    write = attention._write_rows

    def counted_write(*args):
        before = sum(counter.coll.values()) if counter else 0.0
        write(*args)
        if counter:
            written[0] += sum(counter.coll.values()) - before
    attention._write_rows = counted_write
    for case in SERVE_CASES:
        name, _, _, shape, kind, _, _, max_len = case
        over = {"decode": rules.DECODE_OVERRIDES,
                "long": rules.LONG_CONTEXT_OVERRIDES}[kind]
        cfg = serve_config(case)
        model = get_model(cfg)
        cp = model.compute_params(model.init_params(SEED, device="cpu"))
        mesh = mesh_lib.make_host_mesh(data=shape[0], model=shape[1],
                                       device_type="cpu")
        cp = rules.distribute_tree(cp, rules.tree_shardings(
            mesh, model.param_specs(), cp, overrides=over))
        prompt = shard_batch({"tokens": torch.from_numpy(
            serve_prompt(case))}, mesh)
        toks = torch.from_numpy(serve_tokens(case))
        counter, written[0] = None, 0.0
        with mesh_lib.use_mesh(mesh, state_overrides=over), \
                implicit_replication(), torch.no_grad():
            logits, state = model.prefill(cp, prompt, max_len)
            out[f"{name}/prefill"] = _np(logits)
            kv = state["shared_kv"]["k"] if "shared_kv" in state \
                else state["k"]
            out[f"{name}/cache_placements"] = np.asarray(
                [repr(p) for p in kv.placements])
            for i in range(SERVE_STEPS):
                token = shard_batch({"token": toks[:, i:i + 1]},
                                    mesh)["token"]
                counter = roof.CostCounter()
                with counter:
                    logits, state = model.decode_step(cp, token, state)
                out[f"{name}/step{i}"] = _np(logits)
            out[f"{name}/sites"] = np.asarray(json.dumps(
                counter.coll_by_site))
            out[f"{name}/write_bytes"] = np.asarray(written[0])
    attention._write_rows = write


def rank(group, r, world, store, path):
    import logging

    import torch
    import torch.distributed as dist
    logging.disable(logging.WARNING)   # DTensor's per-op advice
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=r, world_size=world,
                            timeout=timedelta(seconds=120))
    out = {}
    try:
        if group == "placements":
            _placements(out)
        elif group == "train":
            _train(out)
        elif group == "launcher":
            _launcher(out)
        elif group == "serve":
            _serve(out)
        elif group == "resume":
            with tempfile.TemporaryDirectory() as d:
                shared = [d]
                dist.broadcast_object_list(shared, src=0)
                _resume(out, shared[0])
        else:
            raise ValueError(group)
        if r == 0:
            np.savez(path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    if sys.argv[1] == "indices":
        indices(sys.argv[2])
    else:
        rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
             sys.argv[6])
