"""Distributed matricized LSE over ``torch.distributed`` ranks: the paper's
parallelization at mesh scale with one O(m²) all-reduce (the PyTorch
port's counterpart of ``examples/distributed_fit.py``).

    # N ranks, one card each (NCCL):
    PYTHONPATH=src torchrun --nproc-per-node N examples/torch_distributed_fit.py
    # a single rank on the card, or on the CPU (gloo):
    PYTHONPATH=src python examples/torch_distributed_fit.py
    PYTHONPATH=src python examples/torch_distributed_fit.py --device cpu

Under ``torchrun`` each rank reads RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT from its environment; run alone, the script
initializes a 1-rank group on a ``FileStore`` in a temporary directory.
Every rank draws the same global series from the seed and fits its own
contiguous block; rank 0 prints the fit, the point count and the bytes
the fit all-reduced at n and at 2n points (the same: the payload is
O(m²), whatever n is).
"""
import argparse
import os
import tempfile
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import core, engine
from repro_torch.launch import mesh as mesh_lib


def series(n: int, seed: int):
    """A noisy cubic on [-4, 4]: x, y and the true monomial coefficients."""
    rng = np.random.default_rng(seed)
    true = np.array([0.5, -2.0, 0.25, 0.1])
    x = rng.uniform(-4.0, 4.0, n)
    y = np.polyval(true[::-1], x) + rng.normal(0.0, 2.0, n)
    return x.astype(np.float32), y.astype(np.float32), true


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 22,
                    help="global series length (a multiple of the ranks)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    backend = "nccl" if args.device == "cuda" else "gloo"
    tmp = None
    if "RANK" in os.environ:
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, timeout=timedelta(seconds=120))
    else:
        tmp = tempfile.TemporaryDirectory()
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp.name, "store"), 1),
            rank=0, world_size=1, timeout=timedelta(seconds=120))
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        dev = (torch.device("cuda", torch.cuda.current_device())
               if args.device == "cuda" else torch.device("cpu"))
        mesh = mesh_lib.make_host_mesh(data=world, device_type=args.device)
        fit = core.make_distributed_fit(mesh, 3, normalize=True)

        sent = []
        for n in (args.n, 2 * args.n):
            x, y, true = series(n, args.seed)
            nb = n // world
            block = slice(rank * nb, (rank + 1) * nb)
            xb = torch.from_numpy(x[block]).to(dev)
            yb = torch.from_numpy(y[block]).to(dev)
            engine.reset_collective_counter()
            poly, moments = fit(xb, yb)
            sent.append(engine.collective_counter())
            if n == args.n and rank == 0:
                print(f"mesh: {world} rank(s) over {args.device} "
                      f"({backend}), {n:,} points, {nb:,} per rank")
                print("true coeffs     :", true)
                print("distributed fit :",
                      poly.monomial_coeffs().cpu().numpy())
                print("points seen     :", int(moments.count))
        if rank == 0:
            for n, cc in zip((args.n, 2 * args.n), sent):
                print(f"all-reduced for {n:,} points: {cc['bytes']} B in "
                      f"{cc['calls']} calls (sum {cc['sum']}, min "
                      f"{cc['min']}, max {cc['max']})")
            print("the payload is the same at n and 2n: "
                  f"{sent[0] == sent[1]}")
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    main()
