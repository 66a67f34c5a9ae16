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
