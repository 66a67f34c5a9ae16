"""Device meshes over ``torch.distributed`` ranks (port of
``repro.launch.mesh``).

Functions, not module constants: importing this module never initializes
a process group or touches CUDA.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, which the caller initializes first
(``torch.distributed.init_process_group`` with its backend, address, world
size and rank); there is no hidden initialization and no switch to the
CPU.  Each rank calls the mesh factory, as every ``DeviceMesh`` is built
collectively.
"""
from __future__ import annotations

import threading

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _world_size() -> int:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no default process group: call torch.distributed."
            "init_process_group(backend, init_method=..., world_size=..., "
            "rank=...) on every rank before building a mesh")
    return dist.get_world_size()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    world = _world_size()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {size} ranks; "
                         f"the process group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 over ("data", "model") (256 ranks), or 2×16×16 over ("pod",
    "data", "model") (512 ranks)."""
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device_type)
    return _mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device_type)


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the ranks of the initialized default
    group; ``data`` defaults to ``world // model``.  Rank r sits at
    (r // model, r % model)."""
    world = _world_size()
    data = data or (world // model)
    return _mesh((data, model), PRODUCTION_AXES, device_type)


def required_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


# ------------------------------------------------------------ ambient mesh
_AMBIENT = threading.local()       # each thread's stack of use_mesh blocks


def _stack() -> list:
    if not hasattr(_AMBIENT, "stack"):
        _AMBIENT.stack = []
    return _AMBIENT.stack


class use_mesh:
    """``with use_mesh(mesh):`` makes ``mesh`` the ambient mesh that
    ``sharding.constrain`` and the dry run read (the counterpart of
    ``jax.set_mesh``).  It initializes nothing; ``None`` masks an outer
    mesh.  Nests, per thread; a context manager only, so no mesh outlives
    its block.

    ``state_overrides``: the rule overrides a decode state made inside a
    model is laid out with (``sharding.constrain_state``), as the
    reference's serving cells give them to the state's out-shardings;
    activations' constraints never read them."""

    def __init__(self, mesh, state_overrides: dict | None = None):
        self.mesh = mesh
        self.state_overrides = state_overrides

    def __enter__(self):
        _stack().append(self)
        return self.mesh

    def __exit__(self, *exc):
        _stack().pop()
        return False


def current_mesh():
    """This thread's innermost ``use_mesh`` mesh, or None."""
    stack = _stack()
    return stack[-1].mesh if stack else None


def current_state_overrides() -> dict | None:
    """This thread's innermost ``use_mesh``'s ``state_overrides``."""
    stack = _stack()
    return stack[-1].state_overrides if stack else None


def init_fake_process_group(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks on the "fake"
    backend: this process plays rank ``rank`` and every collective returns
    at once without moving data.  For dry runs only (shapes, FLOPs and
    collective sizes are real, values are not).  The backend lives in
    ``torch.testing._internal``, a private module of the installed torch;
    this is the one place the port reaches it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


class fake_tensors:
    """``with fake_tensors():`` is ``FakeTensorMode`` for a dry run: tensors
    made inside have shapes, dtypes and devices and no storage.  DTensor
    works out a strided shard's local size from a small index tensor
    (``_StridedShard.local_shard_size_and_offset``), which under fake
    tensors has no values to read; inside this block that arithmetic runs
    on real tensors (a few integers per call).  Both reach private parts of
    the installed torch, pinned here with the fake backend above."""

    def __enter__(self):
        from torch._subclasses.fake_tensor import (FakeTensorMode,
                                                   unset_fake_temporarily)
        from torch.distributed.tensor import placement_types as pt
        self._patched = None
        cls = getattr(pt, "_StridedShard", None)
        orig = getattr(cls, "local_shard_size_and_offset", None)
        if orig is not None:
            def real(*args, **kwargs):
                with unset_fake_temporarily():
                    return orig(*args, **kwargs)
            cls.local_shard_size_and_offset = real
            self._patched = (cls, orig)
        self._mode = FakeTensorMode()
        return self._mode.__enter__()

    def __exit__(self, *exc):
        out = self._mode.__exit__(*exc)
        if self._patched is not None:
            cls, orig = self._patched
            cls.local_shard_size_and_offset = orig
        return out
