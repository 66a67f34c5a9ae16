"""The two sides of ``tests/test_torch_distributed.py``'s multi-rank run.

    python tests/_torch_mesh_ranks.py reference OUT.npz
    python tests/_torch_mesh_ranks.py rank RANK WORLD STORE OUT.npz

``reference`` runs the JAX reference's mesh executor (``repro.api``
``spec.distributed`` and the ``repro.core`` shims) on a host platform of
8 CPU devices (the caller sets ``XLA_FLAGS=--xla_force_host_platform_
device_count=8``): the 4-block runs on ``make_host_mesh(data=4,
model=2)``, the (2, 2) runs on ``make_host_mesh(data=2, model=2)``.
``rank`` is one of 4 gloo ranks of the port (``FileStore`` at STORE): the
same runs on ``make_host_mesh(data=4)`` and ``make_host_mesh(data=2,
model=2)``, each rank passing its own block.  Both walk ``RUNS`` with
specs built from their own package's ``api``, and write one ``.npz``:
per run the coefficients, the chosen degree, the point count, the
iteration count, the condition estimate and (port only) the collective
counter.  The port side imports neither jax nor ``repro``.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

N = 1024
WORLD = 4

# (name, builder, y, absolute slack): tests/test_api.py MATRIX_CELLS,
# then the cells this file adds (decay, CV search, the legacy shims)
CASES = [
    ("lse-monomial-d3", lambda a: a.FitSpec(degree=3), "noisy", 0.0),
    ("lse-chebyshev-d4-pinned",
     lambda a: a.FitSpec(degree=4, basis="chebyshev", domain=(0.0, 0.5)),
     "noisy", 0.0),
    ("lse-decayless-ridge", lambda a: a.FitSpec(degree=2, ridge=1e-6),
     "noisy", 0.0),
    ("irls-huber-d3", lambda a: a.FitSpec(degree=3, method="irls"),
     "exact", 1e-4),
    ("irls-tukey-cheb-d3",
     lambda a: a.FitSpec(degree=3, basis="chebyshev", domain=(0.0, 0.5),
                         method="irls", irls=a.IRLSOptions(loss="tukey")),
     "exact", 1e-4),
    ("lspia-d3-pinned",
     lambda a: a.FitSpec(degree=3, method="lspia", domain=(0.0, 0.5)),
     "noisy", 5e-3),
    ("search-aicc-lse",
     lambda a: a.FitSpec(degree=a.DegreeSearch(max_degree=5, folds=0,
                                               criterion="aicc")),
     "noisy", 0.0),
    ("search-bic-irls",
     lambda a: a.FitSpec(degree=a.DegreeSearch(max_degree=4, folds=0,
                                               criterion="bic"),
                         method="irls"), "noisy", 5e-3),
    ("decay-0.999", lambda a: a.FitSpec(degree=3, decay=0.999), "noisy",
     0.0),
    ("search-cv-d5-k4",
     lambda a: a.FitSpec(degree=a.DegreeSearch(max_degree=5, folds=4)),
     "noisy", 0.0),
    # the legacy shims: make_distributed_fit(normalize=True), the
    # weighted-padding case of tests/test_distributed_fit.py, and
    # make_distributed_select
    ("shim-fit-normalize", ("fit", dict(degree=3, normalize=True)),
     "noisy", 0.0),
    ("shim-fit-padding", ("fit", dict(degree=1)), "pad", 0.0),
    ("shim-select-bic",
     ("select", dict(max_degree=5, folds=0, criterion="bic")), "noisy",
     0.0),
]
CASE = {c[0]: c for c in CASES}
MATRIX = [c[0] for c in CASES[:8]]
SPECS = MATRIX + ["decay-0.999", "search-cv-d5-k4"]

# (case, mesh, data axes, dtype); mesh "d4" is 4 blocks over "data",
# "d2m2" the (2, 2) data × model mesh
RUNS = (
    [(c, "d4", ("data",), "float32") for c, *_ in CASES]
    + [(c, "d4", ("data",), "float64") for c in SPECS]
    + [(c, "d2m2", ("data",), "float32")
       for c in ("lse-monomial-d3", "irls-huber-d3", "search-cv-d5-k4",
                 "shim-fit-normalize")]
    + [(c, "d2m2", ("data", "model"), dt)
       for c in ("lse-monomial-d3", "decay-0.999", "irls-tukey-cheb-d3",
                 "search-aicc-lse")
       for dt in ("float32", "float64")])


def run_id(case, mesh, axes, dtype) -> str:
    return f"{case}@{mesh}@{'+'.join(axes)}@{dtype}"


def data(kind: str, dtype: str):
    """(x, y, weights or None) as numpy: tests/test_api.py's series
    (seed 7, x ~ U(-2, 2), the cubic 1 - 0.5x + 0.3x³, noise N(0, 0.05²)
    on "noisy"), or tests/test_distributed_fit.py's ragged line (1000
    points, 24 zero-weight padding) for "pad"."""
    if kind == "pad":
        rng = np.random.default_rng(1)
        x = np.zeros(N, dtype)
        y = np.zeros(N, dtype)
        w = np.zeros(N, dtype)
        x[:1000] = rng.uniform(-5, 5, 1000)
        y[:1000] = 2.0 + 0.5 * x[:1000]
        w[:1000] = 1.0
        return x, y, w
    rng = np.random.default_rng(7)
    x = rng.uniform(-2.0, 2.0, N)
    clean = np.polyval(np.array([1.0, -0.5, 0.0, 0.3])[::-1], x)
    noisy = clean + rng.normal(0, 0.05, N)
    y = noisy if kind == "noisy" else clean
    return x.astype(dtype), y.astype(dtype), None


def _record(out: dict, rid: str, kind: str, res, to_np) -> None:
    """Flatten one run's result (a FitResult, or a shim's tuple)."""
    best = -1
    iters = -1
    if kind == "fit":
        poly, m = res
        count = m.count
    elif kind == "select":
        poly, _, b = res
        best, count = int(to_np(b)), np.nan
    else:
        poly = res.poly
        if res.selection is not None:
            best = int(np.asarray(res.selection.best_degree))
        count = np.nan if res.report is None else res.report.count
        if res.iterations is not None:
            iters = int(to_np(res.iterations))
    out[rid + ".coeffs"] = to_np(poly.coeffs)
    out[rid + ".best"] = np.asarray(best)
    out[rid + ".count"] = np.asarray(to_np(count))
    out[rid + ".iterations"] = np.asarray(iters)
    cond = poly.diagnostics.condition if poly.diagnostics else np.nan
    out[rid + ".cond"] = np.asarray(to_np(cond))


def reference(path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import api, core
    from repro.launch import mesh as mesh_lib
    meshes = {"d4": mesh_lib.make_host_mesh(data=4, model=2),
              "d2m2": mesh_lib.make_host_mesh(data=2, model=2)}
    out = {}
    for case, mesh_name, axes, dtype in RUNS:
        _, build, ykind, _ = CASE[case]
        mesh = meshes[mesh_name]
        with jax.enable_x64(dtype == "float64"):
            x, y, w = (None if a is None else jnp.asarray(a)
                       for a in data(ykind, dtype))
            kind = "spec"
            if isinstance(build, tuple):
                kind, kw = build
                fn = (core.make_distributed_fit if kind == "fit"
                      else core.make_distributed_select)
                key = "degree" if kind == "fit" else "max_degree"
                kw = dict(kw)
                res = fn(mesh, kw.pop(key), data_axes=axes, **kw)(x, y, w)
            else:
                res = build(api).distributed(mesh, data_axes=axes)(x, y, w)
            _record(out, run_id(case, mesh_name, axes, dtype), kind, res,
                    np.asarray)
    np.savez(path, **out)


def rank(r: int, world: int, store: str, path: str) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch import api, core, engine
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=r,
        world_size=world, timeout=timedelta(seconds=60))
    try:
        meshes = {"d4": mesh_lib.make_host_mesh(data=4, device_type="cpu"),
                  "d2m2": mesh_lib.make_host_mesh(data=2, model=2,
                                                  device_type="cpu")}
        out = {}
        t0 = time.perf_counter()
        for case, mesh_name, axes, dtype in RUNS:
            _, build, ykind, _ = CASE[case]
            mesh = meshes[mesh_name]
            pos, blocks = 0, 1
            for ax in axes:
                size = mesh.size(mesh.mesh_dim_names.index(ax))
                pos = pos * size + mesh.get_local_rank(ax)
                blocks *= size
            nb = N // blocks
            x, y, w = (None if a is None
                       else torch.from_numpy(a[pos * nb:(pos + 1) * nb])
                       for a in data(ykind, dtype))
            engine.reset_collective_counter()
            kind = "spec"
            if isinstance(build, tuple):
                kind, kw = build
                fn = (core.make_distributed_fit if kind == "fit"
                      else core.make_distributed_select)
                key = "degree" if kind == "fit" else "max_degree"
                kw = dict(kw)
                res = fn(mesh, kw.pop(key), data_axes=axes, **kw)(x, y, w)
            else:
                res = build(api).distributed(mesh, data_axes=axes)(x, y, w)
            rid = run_id(case, mesh_name, axes, dtype)
            _record(out, rid, kind, res,
                    lambda a: a.cpu().numpy() if torch.is_tensor(a)
                    else np.asarray(a))
            cc = engine.collective_counter()
            out[rid + ".collectives"] = np.array(
                [cc["sum"], cc["min"], cc["max"], cc["bytes"]])
        out["seconds"] = np.asarray(time.perf_counter() - t0)
        np.savez(path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    if sys.argv[1] == "reference":
        reference(sys.argv[2])
    else:
        rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
