"""LM serving launcher: batched requests through the slot-based engine
(mirrors ``repro.launch.serve``), on the card unless ``--device cpu``.

Weights are drawn from a seeded generator (no checkpoint is read). Every
``--arch`` without a frontend serves (dense, moe, ssm, hybrid); whisper and
llava need frame or patch embeddings that a request does not carry, and
raise ValueError.
Example (CPU smoke config):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --arch granite-3-2b --requests 8 --max-new 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.registry import ARCHS
from repro_torch.models.model import init_params
from repro_torch.serving import Request, ServingEngine
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # no card and no --device cpu: raise
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(gen, cfg, device=device)
    engine = ServingEngine(params, cfg, max_seq=args.max_seq, batch_slots=args.slots,
                           device=device)

    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, 24)).tolist(),
            max_new_tokens=args.max_new,
        )
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(o) for o in outs)
    print(f"served {len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s)")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {len(o)} tokens: {o[:10]}...")
    return outs


if __name__ == "__main__":
    main()
