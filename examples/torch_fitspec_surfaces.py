"""One declarative FitSpec, four execution surfaces, on the PyTorch port
(the counterpart of ``examples/fitspec_surfaces.py``).

    PYTHONPATH=src python examples/torch_fitspec_surfaces.py           # CUDA
    PYTHONPATH=src python examples/torch_fitspec_surfaces.py --device cpu
    # the mesh surface on N ranks, one card each (NCCL; gloo on the CPU):
    PYTHONPATH=src torchrun --nproc-per-node N examples/torch_fitspec_surfaces.py

The same spec — robust (Tukey IRLS) cubic fitting under 15% gross
contamination — runs eagerly, over a chunked stream, on a
``torch.distributed`` mesh, and through the continuous-batching fit
server, and every surface returns the same coefficients.  Under
``torchrun`` each rank fits its contiguous block on the mesh (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT from its
environment); run alone, the mesh is a 1-rank group on a ``FileStore`` in
a temporary directory.  Rank 0 prints the reference's lines and one JSON
line of the numbers and of the kernels' launch counts.
"""
import argparse
import json
import os
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.core import streaming
from repro_torch.device import resolve_device
from repro_torch.kernels import moments as kernels
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve import FitServeConfig, FitServeEngine


def data(n: int = 8192, seed: int = 0):
    """The reference's contaminated cubic, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-2.0, 2.0, n)
    true = np.array([1.0, -0.5, 0.0, 0.3])
    ys = np.polyval(true[::-1], xs) + rng.normal(0, 0.05, n)
    bad = rng.choice(n, n * 15 // 100, replace=False)
    ys[bad] += rng.choice([-1.0, 1.0], bad.size) * 50.0      # gross outliers
    return xs.astype(np.float32), ys.astype(np.float32), true


def host(t) -> list:
    return t.detach().cpu().tolist()


def mesh_fit(spec, xs, ys, dev):
    """Surface 3 on this process's rank of the default group: the rank's
    contiguous block through ``spec.distributed``."""
    world, rank = dist.get_world_size(), dist.get_rank()
    nb = xs.shape[0] // world
    block = slice(rank * nb, (rank + 1) * nb)
    mesh = mesh_lib.make_host_mesh(data=world, device_type=dev.type)
    out = spec.distributed(mesh)(torch.from_numpy(xs[block]).to(dev),
                                 torch.from_numpy(ys[block]).to(dev))
    return out, world


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    dev = resolve_device(ap.parse_args(argv).device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    tmp = None
    if "RANK" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, timeout=timedelta(seconds=120))
    else:
        tmp = tempfile.TemporaryDirectory()
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp.name, "store"), 1),
            rank=0, world_size=1, timeout=timedelta(seconds=120))
    try:
        return run(dev)
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            tmp.cleanup()


def run(dev) -> int:
    kernels.reset_launch_counts()
    xs, ys, true = data()
    n = xs.shape[0]
    x = torch.from_numpy(xs).to(dev)
    y = torch.from_numpy(ys).to(dev)
    spec = api.FitSpec(degree=3, method="irls",
                       irls=api.IRLSOptions(loss="tukey"))
    lead = dist.get_rank() == 0

    def say(*a):
        if lead:
            print(*a)

    say(f"spec: {spec}\ntrue coeffs: {true}\n")

    # 1 — eager
    res = api.fit(x, y, spec, device=dev)
    say("eager       :", host(res.coeffs),
        f"({int(res.iterations)} IRLS sweeps)")

    # 2 — streaming: chunk updates reweight against the running fit
    state = spec.streaming(device=dev)
    for lo in range(0, n, 1024):
        state = streaming.update(state, x[lo:lo + 1024], y[lo:lo + 1024])
    stream = api.stream_result(state)
    say("streaming   :", host(stream.coeffs))

    # 3 — distributed: one O(m²) collective per IRLS sweep
    dist_out, world = mesh_fit(spec, xs, ys, dev)
    say(f"distributed : {host(dist_out.coeffs)} ({world} rank(s))")

    # 4 — the fit server: per-request spec, one step key per spec
    engine = FitServeEngine(FitServeConfig(degree=3, n_slots=4,
                                           buckets=(2048,)), device=dev)
    engine.warmup()
    req = engine.submit(xs, ys, spec=spec)
    engine.run()
    say("serve       :", req.coeffs.tolist(), f"(R={req.r:.4f})")

    # plain LSE for contrast: the outliers drag every surface identically
    plain = api.fit(x, y, api.FitSpec(degree=3), device=dev)
    say("\nplain LSE    :", host(plain.coeffs), "<- dragged by outliers")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if lead:
        print(json.dumps({
            "device": str(dev), "ranks": world, "true": true.tolist(),
            "eager": host(res.coeffs), "iterations": int(res.iterations),
            "streaming": host(stream.coeffs),
            "distributed": host(dist_out.coeffs),
            "serve": req.coeffs.tolist(), "serve_r": float(req.r),
            "plain": host(plain.coeffs),
            "launches": kernels.launch_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
