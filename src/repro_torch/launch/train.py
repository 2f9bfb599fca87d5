"""Training launcher with checkpoint/restart (mirrors ``repro.launch.train``),
on the card unless ``--device cpu``.

  * --resume: restart from the latest checkpoint (atomic, written on a
    thread of its own); the deterministic token stream replays the exact
    batch sequence;
  * --smoke: the reduced config of the chosen arch.

Every ``--arch`` trains; a frontend is dropped first, as the reference's
token-only launcher drops it (whisper keeps its encoder's parameters, which
the loss then does not read). Parameters are drawn from a seeded generator
on the device. Example (CPU, the smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch granite-3-2b --smoke --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.registry import ARCHS
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.train.loop import make_train_step, train_state_init
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"), default="adamw")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where training runs: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # no card and no --device cpu: raise
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    if cfg.frontend is not None:
        cfg = dataclasses.replace(cfg, frontend=None)  # token-only launcher
    opt = adamw() if args.optimizer == "adamw" else adafactor()
    lr = warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = make_train_step(cfg, opt, lr, microbatches=args.microbatches)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = train_state_init(gen, cfg, opt[0], device=device)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        if args.resume:
            restored, step = ckpt.restore_latest(state)
            if restored is not None:
                state, start_step = restored, step
                print(f"resumed from step {step}")

    stream = SyntheticTokenStream(cfg.vocab_size, args.seq_len, args.batch_size,
                                  seed=args.seed)
    losses = []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, stream.batch(step))
        if ckpt:
            ckpt.maybe_save(state, step + 1)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            tput = args.batch_size * args.seq_len * (step - start_step + 1) / max(dt, 1e-9)
            print(f"step {step:5d}  loss {loss:8.4f}  gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"lr {float(metrics['lr']):.2e}  tok/s {tput:9.0f}", flush=True)
    if ckpt:
        ckpt.maybe_save(state, args.steps, force=True)
        ckpt.wait()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
