"""Batched LM serving engine (mirrors ``repro.serving.engine``): slot-based
continuous batching (lite).

A fixed pool of ``batch_slots`` sequences decodes in lock-step; finished
slots are refilled from the pending queue and prefilled one at a time. Each
slot keeps its own position (the decode path takes a (B,) ``pos``), so
slots at different depths share one decode batch. Greedy or temperature
sampling (a numpy generator seeded at construction); EOS or
``max_new_tokens`` ends a slot.

The reference compiles one prefill per prompt length; here each prefill
simply runs, its causal self-attention one flash kernel launch a layer on
the card. The engine runs on ``device`` (the card unless ``device="cpu"``),
where its parameters must lie.

A :class:`Request` carries a prompt of tokens only, as the reference's
does: a config with a frontend (whisper's frames, llava's patches) cannot
be served, and its first prefill raises ValueError saying so (the
reference's fails with a KeyError).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import ArchConfig, decode_step, init_cache, prefill, tree_leaves
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int | None = None


class ServingEngine:
    def __init__(self, params, cfg: ArchConfig, *, max_seq: int = 512,
                 batch_slots: int = 4, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        wrong = {str(t.device) for t in tree_leaves(params)
                 if t.device.type != self.device.type}
        if wrong:
            raise ValueError(f"ServingEngine on {self.device}: parameters lie on {sorted(wrong)}")
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.slots = batch_slots
        self._rng = np.random.default_rng(seed)

    def generate(self, requests: list[Request]) -> list[list[int]]:
        """Serve all requests; returns generated token lists (per request)."""
        cfg, dev = self.cfg, self.device
        results: list[list[int] | None] = [None] * len(requests)
        queue = list(range(len(requests)))
        b = self.slots

        cache = init_cache(cfg, b, self.max_seq, device=dev)
        pos = np.zeros(b, np.int64)  # next write position per slot
        remaining = np.zeros(b, np.int64)
        req_of_slot = [-1] * b
        last_tok = np.zeros((b, 1), np.int64)
        gen: list[list[int]] = [[] for _ in range(b)]

        def fill_slot(slot: int):
            if not queue:
                req_of_slot[slot] = -1
                remaining[slot] = 0
                return
            ridx = queue.pop(0)
            req = requests[ridx]
            plen = len(req.prompt)
            toks = torch.as_tensor([req.prompt], dtype=torch.long, device=dev)
            logits, pc = prefill(self.params, cfg, {"tokens": toks}, self.max_seq)
            # splice this sequence's prefill cache into the batch cache
            _splice_cache(cache, pc, slot)
            tok = int(torch.argmax(logits[0, -1]))
            req_of_slot[slot] = ridx
            pos[slot] = plen
            remaining[slot] = req.max_new_tokens - 1
            last_tok[slot, 0] = tok
            gen[slot] = [tok]

        for s in range(b):
            fill_slot(s)

        while any(r >= 0 for r in req_of_slot):
            logits, cache = decode_step(
                self.params, cfg, cache, torch.as_tensor(last_tok, device=dev),
                torch.as_tensor(pos, device=dev),
            )
            logits = logits[:, 0].cpu().numpy()
            for s in range(b):
                if req_of_slot[s] < 0:
                    continue
                req = requests[req_of_slot[s]]
                if req.temperature > 0:
                    z = logits[s] / req.temperature
                    z = z - z.max()
                    p = np.exp(z) / np.exp(z).sum()
                    tok = int(self._rng.choice(len(p), p=p))
                else:
                    tok = int(np.argmax(logits[s]))
                pos[s] += 1
                gen[s].append(tok)
                remaining[s] -= 1
                done = remaining[s] <= 0 or (req.eos_id is not None and tok == req.eos_id)
                if done or pos[s] >= self.max_seq - 1:
                    results[req_of_slot[s]] = gen[s]
                    fill_slot(s)
                else:
                    last_tok[s, 0] = tok
        return [r if r is not None else [] for r in results]


def _splice_cache(batch_cache, single_cache, slot: int):
    """Copy sequence 0 of ``single_cache`` into ``slot`` of ``batch_cache``,
    in place: axis 1 of every leaf (g, b, ...), as the reference does."""
    for bc, sc in zip(tree_leaves(batch_cache), tree_leaves(single_cache)):
        bc[:, slot] = sc[:, 0].to(bc.dtype)
    return batch_cache
