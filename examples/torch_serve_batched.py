"""Batched serving with continuous batching on a reduced model, on the
PyTorch port (the counterpart of ``examples/serve_batched.py``).

    PYTHONPATH=src python examples/torch_serve_batched.py           # CUDA
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serve import EngineConfig, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = configs.get_smoke_config("yi-6b")
    model = get_model(cfg)
    params = model.init_params(0, device=dev)
    engine = ServeEngine(model, params, EngineConfig(n_slots=4, max_len=96),
                         generator=torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(10):
        prompt = rng.integers(3, 250, 6 + i).tolist()
        reqs.append(engine.submit(prompt, max_new_tokens=16,
                                  temperature=0.7 if i % 2 else 0.0))

    t0 = time.perf_counter()
    engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    done = sum(r.done for r in reqs)
    print(f"served {len(reqs)} requests / {total} tokens on {dev} in "
          f"{dt:.1f}s ({total / dt:.1f} tok/s, {done}/{len(reqs)} requests "
          "finished)")
    for r in reqs[:4]:
        print(f"  req {r.uid} (prompt {len(r.tokens)}t, "
              f"T={r.temperature}): {r.out_tokens}")
    return 0 if done == len(reqs) else 1


if __name__ == "__main__":
    sys.exit(main())
