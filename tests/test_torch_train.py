"""LM training in the port (``repro_torch.train``, ``checkpoint``,
``launch.train``) against ``repro`` on the granite-3-2b smoke config
(float32 compute), from the reference's parameters carried across with
``params_from_arrays``, plus the flash kernel's gradient wiring.

Tolerances, each stated beside its check: the loss within 1e-5 relative and
the gradients within 1e-4 relative (plus 1e-6 of the leaf's largest
gradient) of ``jax.value_and_grad``; after three AdamW steps the metrics
within 1e-4 relative and the parameters within 1e-6 absolute (three steps
of at most lr ~ 4.5e-5 each: a gradient that cancels to near zero may
flip the sign of its Adam step); a resumed run's final loss within 1e-4
relative of the straight run's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_smoke as ref_smoke
from repro.data.tokens import SyntheticTokenStream as JStream
from repro.models import model as RM
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.train import loop as jloop
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FlashAttentionFunction, flash_attention_plain
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as TM
from repro_torch.models import params_from_arrays
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.train import TrainState, loss_fn, make_train_step
from repro_torch.utils import tree_flatten, tree_flatten_with_paths

ARCH = "granite-3-2b"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    """(reference cfg, port cfg, reference params, the token stream)."""
    jcfg = ref_smoke(ARCH)
    params = RM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, get_smoke(ARCH), params, JStream(jcfg.vocab_size, 16, 4, seed=0)


def carried(jparams, cfg):
    return params_from_arrays(jax.tree.map(np.asarray, jparams), cfg, device=CPU)


def port_state(jstate, cfg, opt) -> TrainState:
    """The port's state from a reference TrainState at step 0."""
    params = carried(jstate.params, cfg)
    return TrainState(params=params, opt_state=opt[0](params),
                      step=torch.zeros((), dtype=torch.int32))


def assert_tree_close(got, want, rtol, atol_frac=0.0, atol=0.0):
    got_l, want_l = tree_flatten(got)[0], jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = np.asarray(w)
        floor = atol + atol_frac * float(np.max(np.abs(w)))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=rtol, atol=floor)


def test_loss_and_gradients_match_jax_value_and_grad(ref):
    """loss_fn and its gradients (remat on, as in both configs) against
    jax.value_and_grad of the reference's loss_fn: loss within 1e-5
    relative, gradients within 1e-4 relative plus 1e-6 of each leaf's
    largest; the leaves in the same (sorted-key) order."""
    jcfg, cfg, jparams, stream = ref
    batch = stream.batch(0)
    (jloss, _aux), jgrads = jax.value_and_grad(jloop.loss_fn, has_aux=True)(
        jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    params = carried(jparams, cfg)
    leaves, rebuild = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _aux = loss_fn(rebuild(leaves), cfg, tbatch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert_tree_close(rebuild(list(grads)), jgrads, rtol=1e-4, atol_frac=1e-6)


def run_reference(jcfg, jstate, stream, steps, opt, lr, microbatches=1, start=0):
    step = jloop.make_train_step(jcfg, opt, lr, microbatches=microbatches, donate=False)
    metrics = []
    for s in range(start, start + steps):
        jstate, m = step(jstate, jax.tree.map(jnp.asarray, stream.batch(s)))
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, metrics


def run_port(cfg, state, stream, steps, opt, lr, microbatches=1, start=0):
    step = make_train_step(cfg, opt, lr, microbatches=microbatches)
    metrics = []
    for s in range(start, start + steps):
        state, m = step(state, stream.batch(s))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_steps_match_the_reference_step(ref, microbatches, optimizer):
    """make_train_step against the reference's jitted step from the same
    state: loss, grad norm and lr within 1e-4 relative at every step, the
    parameters within 1e-6 absolute after the third."""
    jcfg, cfg, jparams, stream = ref
    jopt, opt = (j_adamw(), adamw()) if optimizer == "adamw" else (j_adafactor(), adafactor())
    jstate = jloop.TrainState(params=jparams, opt_state=jopt[0](jparams), step=jnp.int32(0))
    state = port_state(jstate, cfg, opt)
    jstate, want = run_reference(jcfg, jstate, stream, 3, jopt, j_warmup_cosine(3e-4, 2, 10),
                                 microbatches)
    state, got = run_port(cfg, state, stream, 3, opt, warmup_cosine(3e-4, 2, 10), microbatches)
    for g, w in zip(got, want):
        for key in ("loss", "grad_norm", "lr", "aux_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-12)
    assert int(state.step) == 3
    assert_tree_close(state.params, jstate.params, rtol=0, atol=1e-6)


def test_reference_checkpoint_resumes_in_the_port(ref, tmp_path):
    """The reference trains 3 steps and checkpoints; the port restores that
    checkpoint into its own state and trains 3 more; the final loss lands
    within 1e-4 relative of 6 straight reference steps. The port's own
    checkpoint of the result restores in the reference."""
    jcfg, cfg, jparams, stream = ref
    jopt, opt = j_adamw(), adamw()
    jlr, lr = j_warmup_cosine(3e-4, 2, 6), warmup_cosine(3e-4, 2, 6)
    j0 = jloop.TrainState(params=jparams, opt_state=jopt[0](jparams), step=jnp.int32(0))
    _, straight = run_reference(jcfg, j0, stream, 6, jopt, jlr)
    j3, _ = run_reference(jcfg, j0, stream, 3, jopt, jlr)
    jm = JManager(str(tmp_path / "ref"), every=1, async_saves=False)
    jm.maybe_save(j3, 3)
    template = port_state(j0, cfg, opt)
    restored, step = CheckpointManager(str(tmp_path / "ref")).restore_latest(template)
    assert step == 3 and int(restored.step) == 3 and int(restored.opt_state.step) == 3
    state, resumed = run_port(cfg, restored, stream, 3, opt, lr, start=3)
    np.testing.assert_allclose(resumed[-1]["loss"], straight[-1]["loss"], rtol=1e-4)
    mine = CheckpointManager(str(tmp_path / "port"), every=1, async_saves=True)
    mine.maybe_save(state, 6)
    mine.wait()
    back, jstep = JManager(str(tmp_path / "port")).restore_latest(j3)
    assert jstep == 6 and int(back.step) == 6
    assert_tree_close(state.params, back.params, rtol=0, atol=0)
    assert_tree_close(state.opt_state.v, back.opt_state.v, rtol=0, atol=0)


def test_checkpoint_manager_retention_and_errors(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3), "n": {"b": torch.ones(3)}}
    m = CheckpointManager(str(tmp_path), every=2, keep_last=2)
    saved = [s for s in range(1, 8) if m.maybe_save(state, s)]
    m.wait()
    assert saved == [2, 4, 6] and latest_step(str(tmp_path)) == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4", "step_6"]
    state["w"] += 1  # the snapshot was taken before: step_6 holds the old values
    back, step = m.restore_latest({"w": torch.zeros(2, 3), "n": {"b": torch.zeros(3)}})
    assert step == 6 and torch.equal(back["w"], torch.arange(6.0).reshape(2, 3))
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(state) == (None, None)
    with pytest.raises(ValueError):
        m.restore_latest({"w": torch.zeros(3, 2), "n": {"b": torch.zeros(3)}})
    (tmp_path / "blocked").write_text("a file where the directory should go")
    bad = CheckpointManager(str(tmp_path / "blocked"), every=1)
    bad.maybe_save(state, 1)
    with pytest.raises(RuntimeError, match="checkpoint write"):
        bad.wait()


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_tree_flatten_with_paths_is_jax_flatten_with_path(ref, optimizer):
    """The port's one tree walker gives a training state's leaves in JAX's
    order with JAX's key-path strings (what the checkpoint's manifest
    holds), and its rebuild gives back the same dataclasses and leaves."""
    jcfg, cfg, jparams, _ = ref
    jopt, opt = {"adamw": (j_adamw(), adamw()),
                 "adafactor": (j_adafactor(), adafactor())}[optimizer]
    j0 = jloop.TrainState(params=jparams, opt_state=jopt[0](jparams), step=jnp.int32(0))
    state = port_state(j0, cfg, opt)
    paths, leaves, rebuild = tree_flatten_with_paths(state)
    want = jax.tree_util.tree_flatten_with_path(j0)[0]
    assert paths == [jax.tree_util.keystr(p) for p, _ in want]
    for leaf, (_, w) in zip(leaves, want):
        assert tuple(leaf.shape) == np.shape(w)
    back = rebuild(leaves)
    assert type(back) is type(state) and type(back.opt_state) is type(state.opt_state)
    assert all(a is b for a, b in zip(tree_flatten(back)[0], leaves))


def test_checkpoint_manager_writes_in_the_caller_without_async_saves(tmp_path):
    """async_saves=False (the reference's tests/test_checkpoint.py:35 case):
    each save is on disk when maybe_save returns, keep-last GC included,
    and a failed write raises from maybe_save itself."""
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": torch.zeros((), dtype=torch.int32)}
    m = CheckpointManager(str(tmp_path), every=1, keep_last=2, async_saves=False)
    for s in (1, 2, 3, 4):
        assert m.maybe_save(state, s) and latest_step(str(tmp_path)) == s
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3", "step_4"]
    back, step = m.restore_latest({"w": torch.zeros(2, 3),
                                   "step": torch.ones((), dtype=torch.int32)})
    assert step == 4 and torch.equal(back["w"], state["w"]) and back["step"].shape == ()
    (tmp_path / "blocked").write_text("a file where the directory should go")
    bad = CheckpointManager(str(tmp_path / "blocked"), every=1, async_saves=False)
    with pytest.raises(OSError):
        bad.maybe_save(state, 1)


# ------------------------------------------------ the flash kernel's gradient --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradient_is_the_plain_functions(dtype, causal):
    """With the plain version in the kernel's place, the Function's forward
    and its gradients equal autograd through the plain function, bit for
    bit (the backward recomputes it from the saved inputs)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.standard_normal((3, n, 16)).astype(np.float32)).to(dtype)
               for n in (7, 9, 9))
    g = torch.tensor(rng.standard_normal((3, 7, 16)).astype(np.float32)).to(dtype)
    inputs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FlashAttentionFunction.apply(*inputs, causal, flash_attention_plain)
    got = torch.autograd.grad(out, inputs, g)
    plain_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = flash_attention_plain(*plain_in, causal)
    want = torch.autograd.grad(want_out, plain_in, g)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, False])
def test_kernel_path_gives_every_attention_weight_a_gradient(ref, monkeypatch, remat):
    """forward on the kernel path, the kernel's place taken by the plain
    version cut from the graph (as a ctypes launch writes its output):
    every attention weight still gets a gradient, within 1e-4 relative of
    the plain path's, and the launches a step are one a layer plus one a
    layer for the recompute under remat."""
    jcfg, cfg, jparams, stream = ref
    cfg = dataclasses.replace(cfg, remat=remat)
    launches = []

    def cut(q, k, v, causal):
        launches.append(q.shape)
        return flash_attention_plain(q, k, v, causal).detach()

    monkeypatch.setattr(ops, "flash_attention_cuda", cut)
    batch = {k: torch.as_tensor(v) for k, v in stream.batch(1).items()}
    grads = {}
    for impl in ("kernel", "torch"):
        params = carried(jparams, cfg)
        leaves, rebuild = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(rebuild(leaves), cfg, batch, impl=impl)
        grads[impl] = rebuild(list(torch.autograd.grad(loss, leaves)))
    assert len(launches) == cfg.n_layers * (2 if remat else 1)
    for name in ("wq", "wk", "wv", "wo"):
        got = grads["kernel"]["blocks"]["l0"]["attn"][name]["w"]
        want = grads["torch"]["blocks"]["l0"]["attn"][name]["w"]
        assert float(got.abs().min(dim=-1).values.max()) > 0, name
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))
    with torch.no_grad():  # serving: the bare launch, no Function
        launches.clear()
        TM.forward(carried(jparams, cfg), cfg, batch, impl="kernel")
    assert len(launches) == cfg.n_layers


# ------------------------------------------------------------ the launcher --
def test_train_launcher_on_the_cpu(tmp_path, capsys):
    """launch.train's main: the loss falls over 20 smoke steps with two
    microbatches; 3 + checkpoint + --resume 3 ends where 6 straight steps
    do (1e-4 relative); one Adafactor step; the reference's log lines."""
    base = ["--device", "cpu", "--arch", ARCH, "--smoke", "--seq-len", "32",
            "--batch-size", "4"]
    losses = train_launcher.main(base + ["--steps", "20", "--microbatches", "2", "--warmup",
                                         "2", "--log-every", "19", "--lr", "3e-3"])
    assert len(losses) == 2 and losses[-1] < losses[0]
    # six steps stay inside the default 20-step warmup, so the schedule does
    # not depend on --steps
    straight = train_launcher.main(base + ["--steps", "6", "--log-every", "1"])
    ck = str(tmp_path / "ck")
    train_launcher.main(base + ["--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "1"])
    resumed = train_launcher.main(base + ["--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "1",
                                          "--resume", "--log-every", "1"])
    np.testing.assert_allclose(resumed[-1], straight[-1], rtol=1e-4)
    assert train_launcher.main(base + ["--steps", "1", "--optimizer", "adafactor"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "final loss" in out and "tok/s" in out


def test_train_launcher_refusals():
    """No family is refused any more (a moe config trains: every arch is in
    tests/test_torch_families.py); without a card and without --device cpu
    the launcher raises."""
    losses = train_launcher.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                                  "--smoke", "--steps", "1"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_launcher.main(["--smoke", "--steps", "1"])
