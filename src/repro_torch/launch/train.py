"""End-to-end training on one card (port of
``repro.launch.train``).

Runs a zoo arch (its published config, or ``--smoke``'s reduced one) with
the whole substrate engaged: the train state on the device, the synthetic
data pipeline, the LSE loss-curve monitor (divergence detection + ETA),
periodic checkpointing with atomic commit + GC, and crash-resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 8 --ckpt-dir /tmp/ckpt --ckpt-every 4
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --smoke --device cpu --model-parallel 2 --steps 8

Under a process group (``torchrun``'s environment, from which the launcher
starts one: NCCL on CUDA, gloo for ``--device cpu``; or one the caller
started) the state is sharded on ``make_host_mesh(model=N)`` by
``train_state_specs`` and ``tree_shardings``, every leaf a DTensor; each
rank draws the global batch from the pipeline and keeps its data-axis
block, and a resume restores onto the mesh.  Without one, and with
``--model-parallel 1``, it trains unsharded on one device.

A resumed run restarts the pipeline at the checkpoint's step: the
pipeline yields one global batch per step whatever ``--microbatches`` is.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch import checkpoint, configs
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import get_model
from repro_torch.train import (AdamWConfig, LossCurveMonitor, TrainConfig,
                               init_train_state, make_train_step)
from repro_torch.train.train_step import shard_batch, state_shardings


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


def _audio_batch(cfg, batch, seq_len, device):
    """The reference launcher's audio batch: zero frames of (b, seq_len,
    d_model) for the encoder, the tokens as the decoder's."""
    b = batch["tokens"].shape[0]
    return {"frames": torch.zeros((b, seq_len, cfg.d_model),
                                  dtype=torch.bfloat16, device=device),
            "dec_tokens": batch["tokens"], "labels": batch["labels"],
            "loss_mask": batch["loss_mask"]}


def _process_group(dev) -> bool:
    """Whether this run is one rank of a process group: one the caller
    started, or one this launcher starts from ``torchrun``'s environment
    (NCCL on CUDA, gloo on the CPU; no other backend is tried)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return True


def _host(x) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor gathered whole: collective)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def run(argv=None) -> dict:
    """Parse ``argv`` and train; returns the run's per-step losses
    (``{step: loss}``), its final state and monitor, the step it started
    from, its host-clock wall time and its mesh (None unsharded)."""
    args = parser().parse_args(argv)
    cfg, model, tc = build(args)
    dev = resolve_device(args.device)
    mesh = None
    if _process_group(dev):
        import torch.distributed as dist
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        mesh = mesh_lib.make_host_mesh(model=args.model_parallel,
                                       device_type=dev.type)
        rank0 = dist.get_rank() == 0
    elif args.model_parallel > 1:
        raise RuntimeError(
            f"--model-parallel {args.model_parallel} shards the state over "
            f"a process group; start one rank per device with torchrun, "
            f"e.g. torchrun --nproc-per-node {2 * args.model_parallel} -m "
            f"repro_torch.launch.train --model-parallel "
            f"{args.model_parallel} ...")
    else:
        rank0 = True
    say = print if rank0 else (lambda *a, **k: None)
    layout = ("" if mesh is None else
              f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    say(f"[train] arch={cfg.arch} device={dev}{layout} "
        f"params≈{cfg.param_count()/1e6:.1f}M")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    pipe = TokenPipeline(dcfg, device=dev)

    # seeded from --steps, as the reference launcher seeds its state
    state = init_train_state(model, args.steps, device=dev, mesh=mesh)
    start_step = 0
    if args.ckpt_dir:
        last = checkpoint.latest_step(args.ckpt_dir)
        if last is not None:
            say(f"[train] resuming from step {last}")
            sh = None if mesh is None else state_shardings(model, mesh, state)
            state = checkpoint.restore(args.ckpt_dir, last, state,
                                       shardings=sh)
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
        elif cfg.family == "audio":
            batch = _audio_batch(cfg, batch, args.seq_len, dev)
        if mesh is not None:
            batch = shard_batch(batch, mesh, tc.microbatches)
        state, metrics = step_fn(state, batch)
        loss = float(_host(metrics["loss"]))
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
            gnorm = float(_host(metrics["grad_norm"]))
            say(f"[train] step {step} loss={loss:.4f} gnorm={gnorm:.3f} "
                f"({dt:.1f}s){extras}", flush=True)

        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, state)
            if rank0:
                checkpoint.gc_old(args.ckpt_dir, keep=3)
            say(f"[train] checkpointed step {step + 1}", flush=True)

    say(f"[train] done. final loss {loss:.4f}")
    return {"losses": losses, "state": state, "monitor": monitor,
            "start_step": start_step, "wall_s": time.perf_counter() - t0,
            "mesh": mesh}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
