"""The port's LM serving engine (``repro_torch.serving.ServingEngine``) and
launcher (``python -m repro_torch.launch.serve``) against ``repro``'s on the
same weights and prompts: the three cases of tests/test_serving.py, each
held to the reference engine's tokens and, for greedy decoding, to a
greedy ``forward`` oracle; temperature sampling draws the same tokens from
the same seed; the launcher runs on the CPU when asked (without a card and
without ``--device cpu`` it raises: tests/test_torch_isolation.py)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro.models.model import init_params as ref_init_params
from repro_torch.configs import get_smoke
from repro_torch.models import forward, params_from_arrays
from repro_torch.serving import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def small_model():
    """granite-3-2b smoke: (reference cfg, params; port cfg, params)."""
    ref_cfg, cfg = ref_smoke("granite-3-2b"), get_smoke("granite-3-2b")
    rp = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, rp, cfg, params_from_arrays(jax.tree.map(np.asarray, rp), cfg, device="cpu")


def _greedy_reference(cfg, params, prompt, n_new):
    """Unbatched greedy decode by repeated full forward (the oracle)."""
    toks = list(prompt)
    out = []
    for _ in range(n_new):
        logits, _ = forward(params, cfg, {"tokens": torch.tensor([toks])})
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        toks.append(nxt)
    return out


def _both(small_model, requests, **kw):
    """Generated tokens of the port's engine and the reference's, same
    requests."""
    ref_cfg, rp, cfg, tp = small_model
    port = ServingEngine(tp, cfg, device="cpu", **kw).generate(
        [Request(**r) for r in requests])
    ref = RefEngine(rp, ref_cfg, **kw).generate([RefRequest(**r) for r in requests])
    return port, ref


def test_engine_matches_greedy_reference(small_model):
    _, _, cfg, tp = small_model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9, 7)]
    reqs = [dict(prompt=p, max_new_tokens=6) for p in prompts]
    port, ref = _both(small_model, reqs, max_seq=64, batch_slots=2)
    assert port == ref
    for p, o in zip(prompts, port):
        assert o == _greedy_reference(cfg, tp, p, 6)


def test_engine_more_requests_than_slots(small_model):
    _, _, cfg, _ = small_model
    rng = np.random.default_rng(1)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, 6).tolist(), max_new_tokens=4)
            for _ in range(5)]
    port, ref = _both(small_model, reqs, max_seq=64, batch_slots=2)
    assert len(port) == 5 and all(len(o) == 4 for o in port)
    assert port == ref


def test_engine_eos_stops(small_model):
    _, _, cfg, tp = small_model
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, 6).tolist()
    want = _greedy_reference(cfg, tp, prompt, 8)
    eos = want[2]
    port, ref = _both(small_model, [dict(prompt=prompt, max_new_tokens=8, eos_id=eos)],
                      max_seq=64, batch_slots=1)
    assert port[0] == ref[0] == want[:3]  # stops right after emitting eos


def test_engine_temperature_sampling_matches_reference(small_model):
    """Temperature 0.8 from seed 3: the numpy generator draws in the same
    order, so the same tokens come out."""
    _, _, cfg, _ = small_model
    rng = np.random.default_rng(3)
    reqs = [dict(prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=5,
                 temperature=0.8) for n in (4, 6, 5)]
    port, ref = _both(small_model, reqs, max_seq=32, batch_slots=2, seed=3)
    assert port == ref


def test_engine_refuses_parameters_elsewhere(small_model):
    _, _, cfg, tp = small_model
    meta = {k: v for k, v in tp.items()}
    meta["lm_head"] = {"w": torch.empty(tuple(tp["lm_head"]["w"].shape), device="meta")}
    with pytest.raises(ValueError, match="parameters lie on"):
        ServingEngine(meta, cfg, device="cpu")


def test_launcher_serves_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke",
         "--requests", "4", "--max-new", "8"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 4 requests, 32 tokens in" in out.stdout
    assert sum(ln.startswith("  req") for ln in out.stdout.splitlines()) == 4


def test_launcher_in_process_prints_the_reference_lines(capsys):
    """``main`` in process returns the generated tokens and prints the
    reference launcher's lines: the served count, then one line a request
    (each package draws its own weights, so the tokens differ)."""
    from repro_torch.launch import serve

    outs = serve.main(["--device", "cpu", "--smoke", "--requests", "3", "--max-new", "5",
                       "--slots", "2", "--max-seq", "64"])
    lines = capsys.readouterr().out.splitlines()
    assert [len(o) for o in outs] == [5, 5, 5]
    assert lines[0].startswith("served 3 requests, 15 tokens in")
    assert lines[1] == f"  req0: 5 tokens: {outs[0][:10]}..."
