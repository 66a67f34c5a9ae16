"""End to end on the PyTorch port: train a ~100M-param llama-style
LM for a few hundred steps on synthetic data, with the paper's LSE
loss-curve monitor, periodic checkpointing and crash-resume (the port's
counterpart of ``examples/train_100m.py``).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu \\
        --steps 20 --batch 2 --seq 64

The same loop runs the zoo's published archs through
``repro_torch.launch.train``.
"""
import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.train import (AdamWConfig, LossCurveMonitor, TrainConfig,
                               init_train_state, make_train_step)

# ~100M params: 12L × d640 × ff2560, 32k vocab (llama-ish)
GPT_100M = ModelConfig(
    arch="repro-gpt-100m", family="dense",
    n_layers=12, d_model=640, n_heads=10, n_kv_heads=10, d_ff=2560,
    vocab_size=32_000, rope_theta=10000.0, remat="none")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="torch_100m_ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    model = get_model(GPT_100M)
    print(f"[100m] params≈{GPT_100M.param_count() / 1e6:.1f}M on {dev}")

    tc = TrainConfig(optimizer=AdamWConfig(
        peak_lr=6e-4, warmup_steps=30, total_steps=args.steps))
    step_fn = make_train_step(model, tc)
    pipe = TokenPipeline(DataConfig(vocab_size=GPT_100M.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch), device=dev)
    state = init_train_state(model, 0, device=dev)
    start = 0
    last = checkpoint.latest_step(args.ckpt_dir)
    if last is not None:
        state = checkpoint.restore(args.ckpt_dir, last, state)
        pipe.restore({"batch_idx": last})
        start = last
        print(f"[100m] resumed from step {last}")

    monitor = LossCurveMonitor(degree=2, decay=0.99, device=dev)
    loss = float("nan")
    t0 = time.time()
    for step in range(start, args.steps):
        state, m = step_fn(state, pipe.next())
        loss = float(m["loss"])
        monitor.observe(step, loss)
        if step % 20 == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step - start + 1) \
                / (time.time() - t0)
            msg = (f"[100m] step {step:4d} loss={loss:.4f} "
                   f"lr={float(m['lr']):.2e} {tok_s:.0f} tok/s")
            if monitor.ready:
                msg += f" slope={monitor.slope_at(step):+.2e}"
                eta = monitor.eta_to(4.0, step)
                if eta is not None:
                    msg += f" eta(loss4.0)={eta}st"
            print(msg, flush=True)
        if (step + 1) % 100 == 0:
            checkpoint.save(args.ckpt_dir, step + 1, state)
            checkpoint.gc_old(args.ckpt_dir, keep=2)

    print(f"[100m] final loss {loss:.4f} "
          f"({'improved' if loss < 9.0 else 'check data'}; "
          f"uniform-vocab CE would be {math.log(32000.0):.2f})")


if __name__ == "__main__":
    main()
