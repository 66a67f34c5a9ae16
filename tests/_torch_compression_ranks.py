"""The two sides of ``tests/test_torch_compression.py``'s 8-rank run.

    python tests/_torch_compression_ranks.py reference OUT.npz
    python tests/_torch_compression_ranks.py rank RANK WORLD STORE OUT.npz

``reference`` runs the JAX reference's ``allreduce_compressed`` under
``shard_map`` over ``make_host_mesh(data=8)`` (the caller sets
``XLA_FLAGS=--xla_force_host_platform_device_count=8``), as
``tests/test_compression.py`` does.  ``rank`` is one of 8 gloo ranks of
the port (``FileStore`` at STORE) holding row RANK of the same (8, 512)
gradients, through ``allreduce_compressed`` and, on a dict tree,
``tree_allreduce_compressed``.  Each writes one ``.npz``; the port side
imports neither jax nor ``repro``.
"""
from __future__ import annotations

import sys
from datetime import timedelta

import numpy as np

WORLD = 8


def grads():
    rng = np.random.default_rng(1)
    return rng.normal(0, 1, (WORLD, 512)).astype(np.float32)


def reference(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.launch import mesh as mesh_lib
    from repro.train import compression as comp

    mesh = mesh_lib.make_host_mesh(data=WORLD, model=1)
    g = jnp.asarray(grads())
    res = jnp.zeros_like(g)

    @jax.jit
    @lambda f: jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                             out_specs=(P("data"), P("data")))
    def sync(g, r):
        out, nr = comp.allreduce_compressed(g[0], r[0], "data")
        return out[None], nr[None]

    mean, new_res = sync(g, res)
    np.savez(path, mean=np.asarray(mean), residual=np.asarray(new_res))


def rank(r: int, world: int, store: str, path: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import engine
    from repro_torch.train import compression as comp

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=r, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        g = torch.from_numpy(grads()[r].copy())
        engine.reset_collective_counter()
        mean, res = comp.allreduce_compressed(g, torch.zeros_like(g))
        calls = engine.collective_counter()
        tree = {"a": g[:300].reshape(3, 100), "b": [g[300:]]}
        tmean, tres = comp.tree_allreduce_compressed(
            tree, comp.init_residuals(tree))
    finally:
        dist.destroy_process_group()
    np.savez(path, mean=mean.numpy(), residual=res.numpy(),
             calls=calls["calls"], bytes=calls["bytes"],
             tree_a=tmean["a"].numpy(), tree_b=tmean["b"][0].numpy(),
             tree_res_a=tres["a"].numpy())


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference(sys.argv[2])
    else:
        rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
