"""End-to-end training on one card (port of
``repro.launch.train``).

Runs a zoo arch (its published config, or ``--smoke``'s reduced one) with
the whole substrate engaged: the train state on the device, the synthetic
data pipeline, the LSE loss-curve monitor (divergence detection + ETA),
periodic checkpointing with atomic commit + GC, and crash-resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 8 --ckpt-dir /tmp/ckpt --ckpt-every 4

A resumed run restarts the pipeline at the checkpoint's step: the
pipeline yields one global batch per step whatever ``--microbatches`` is.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import checkpoint, configs
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.train import (AdamWConfig, LossCurveMonitor, TrainConfig,
                               init_train_state, make_train_step)


def build(args):
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    model = get_model(cfg)
    tc = TrainConfig(
        optimizer=AdamWConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                              total_steps=args.steps),
        microbatches=args.microbatches)
    return cfg, model, tc


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--target-loss", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    return ap


def _vlm_batch(cfg, batch, device):
    """Zero image embeddings prepended; labels and mask padded over them."""
    b = batch["tokens"].shape[0]
    n = cfg.n_image_tokens
    batch["extra_embeds"] = torch.zeros((b, n, cfg.d_model),
                                        dtype=torch.bfloat16, device=device)
    batch["labels"] = torch.cat(
        [torch.zeros((b, n), dtype=torch.int32, device=device),
         batch["labels"]], dim=1)
    batch["loss_mask"] = torch.cat(
        [torch.zeros((b, n), dtype=torch.float32, device=device),
         batch["loss_mask"]], dim=1)
    return batch


def run(argv=None) -> dict:
    """Parse ``argv`` and train; returns the run's per-step losses
    (``{step: loss}``), its final state and monitor, the step it started
    from and its host-clock wall time."""
    args = parser().parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs sharding/rules.py and multi-card "
            "training: ROADMAP.md Queue 1 item 15 step 5")
    cfg, model, tc = build(args)
    dev = resolve_device(args.device)
    print(f"[train] arch={cfg.arch} device={dev} "
          f"params≈{cfg.param_count()/1e6:.1f}M")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    pipe = TokenPipeline(dcfg, device=dev)

    # seeded from --steps, as the reference launcher seeds its state
    state = init_train_state(model, args.steps, device=dev)
    start_step = 0
    if args.ckpt_dir:
        last = checkpoint.latest_step(args.ckpt_dir)
        if last is not None:
            print(f"[train] resuming from step {last}")
            state = checkpoint.restore(args.ckpt_dir, last, state)
            start_step = last
            pipe.restore({"batch_idx": last})

    step_fn = make_train_step(model, tc)
    monitor = LossCurveMonitor(device=dev)

    losses = {}
    loss = float("nan")
    t0 = t_last = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = pipe.next()
        if cfg.family == "vlm":
            batch = _vlm_batch(cfg, batch, dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses[step] = loss
        monitor.observe(step, loss)

        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            extras = ""
            if monitor.ready:
                extras = f" fit_slope={monitor.slope_at(step):+.2e}"
                if monitor.diverging(step):
                    extras += " DIVERGING"
                if args.target_loss:
                    eta = monitor.eta_to(args.target_loss, step)
                    extras += f" eta_steps={eta}"
            print(f"[train] step {step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s){extras}", flush=True)

        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, state)
            checkpoint.gc_old(args.ckpt_dir, keep=3)
            print(f"[train] checkpointed step {step + 1}", flush=True)

    print(f"[train] done. final loss {loss:.4f}")
    return {"losses": losses, "state": state, "monitor": monitor,
            "start_step": start_step, "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
