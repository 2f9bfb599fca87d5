"""Tensor parallelism and ZeRO-1 in the port (``repro_torch.models.sharded``,
``repro_torch.models.sharding_utils``, ``train.make_sharded_train_step``)
against the reference's GSPMD runs on the CPU.

The reference runs once for this module in a subprocess with 8 forced host
devices (``run_reference``): for each case, ``jax.jit`` of
``make_train_step(..., jit_compile=False)`` over a state placed by the
sanitized ``train_state_pspecs`` (2 steps), then ``forward``, ``prefill`` and 4
``decode_step`` s over parameters placed by ``param_pspecs`` and a cache by
``cache_pspecs``. The port starts from the same parameters
(``params_from_arrays``) and runs the same batches over a (data, model)
grid of CPU positions.

Cases: smoke granite-3-2b on (data 2, model 2) and (2, 4) (at 4 the KV
heads do not divide: K/V gathered), smoke starcoder2-3b with 6 heads of 16
on (2, 4) (1.5 query heads a position: q, k, v gathered, the output
gathered again for ``wo``) and smoke llava-next-mistral-7b on (2, 2) (the
patch prefix). Tolerances, float32 throughout: loss, grad norm and lr
within 1e-4 relative; every parameter and AdamW moment within 1e-5; the
forward's, the prefill's and each decode step's logits within 1e-5.

With 'model' 1 (ZeRO-1 alone) the sharded step equals the port's own
``make_train_step(microbatches=S)`` within 1e-6 on every leaf (the global
norm sums in another order). The payloads of a step are checked by hand on
one tiny layer, and the counter's per-position attribution of the backward
pass (every position's totals equal where the heads divide).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro_torch.configs import get_smoke
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.mesh import P, make_mesh, tensor_bytes
from repro_torch.models import model as TM
from repro_torch.models import params_from_arrays
from repro_torch.models import sharded as SHD
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import TrainState, make_sharded_train_step, make_train_step
from repro_torch.utils import tree_flatten
from tests.test_torch_data_parallel import run_reference

#: case -> (arch, (data, model))
CASES = {"granite/2x2": ("granite-3-2b", (2, 2)), "granite/2x4": ("granite-3-2b", (2, 4)),
         "starcoder2/2x4": ("starcoder2-3b", (2, 4)), "llava/2x2": ("llava-next-mistral-7b", (2, 2))}
STEPS = 2
BATCH, SEQ = 4, 16  # train batch: 2 rows a data block
PROMPT, MAX_SEQ, DECODE = 12, 32, 4
LR = (3e-4, 2, 10)  # warmup_cosine: the data-parallel tests' schedule


def config(arch, smoke):
    """The smoke config; starcoder2's with 6 heads of 16, which 4 'model'
    positions split inside a head (as 24 heads over 16)."""
    cfg = smoke(arch)
    return dataclasses.replace(cfg, n_heads=6, head_dim=16) if arch == "starcoder2-3b" else cfg


def train_batch(cfg, step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    text = SEQ - (cfg.frontend_len if cfg.frontend == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, text)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (BATCH, text)).astype(np.int32)}
    if cfg.frontend == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def prompt_batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)}
    if cfg.frontend == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def decode_tokens(cfg, t: int) -> np.ndarray:
    return np.random.default_rng(50 + t).integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)


def first_pos(cfg) -> int:
    return PROMPT + (cfg.frontend_len if cfg.frontend == "vlm" else 0)


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_smoke
from repro.launch import sharding as SH
from repro.models import model as RM
from repro.optim import adamw, warmup_cosine
from repro.train import loop
from tests.test_torch_tensor_parallel import (CASES, DECODE, LR, MAX_SEQ, STEPS, config,
                                              decode_tokens, first_pos, prompt_batch,
                                              train_batch)

out = sys.argv[1]
assert len(jax.devices()) == 8, jax.devices()
res = {}
dp = ("data",)


def put(tree, specs, mesh):
    return jax.device_put(tree, SH.to_named(specs, mesh))


for key, (arch, grid) in CASES.items():
    cfg = config(arch, get_smoke)
    # GSPMD's automatic axes, as the production mesh's
    mesh = make_mesh(grid, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:grid[0] * grid[1]])
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        res[f"{key}/init/{i}"] = np.asarray(leaf)
    opt = adamw()
    state = loop.TrainState(params=params, opt_state=opt[0](params), step=jnp.int32(0))
    specs = SH.sanitize_specs(state, SH.train_state_pspecs(state, dp, mesh), mesh)
    step = jax.jit(loop.make_train_step(cfg, opt, warmup_cosine(*LR), jit_compile=False),
                   out_shardings=(SH.to_named(specs, mesh), None))
    with set_mesh(mesh):
        state = put(state, specs, mesh)
        for s in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in train_batch(cfg, s).items()}
            batch = put(batch, SH.sanitize_specs(batch, SH.batch_pspecs(batch, dp), mesh), mesh)
            state, m = step(state, batch)
            for name, v in m.items():
                res[f"{key}/{s}/{name}"] = np.asarray(v)
        for part in ("params", "m", "v"):
            tree = state.params if part == "params" else getattr(state.opt_state, part)
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                res[f"{key}/{part}/{i}"] = np.asarray(leaf)
        pspecs = SH.sanitize_specs(params, SH.param_pspecs(params), mesh)
        pp = put(params, pspecs, mesh)
        fwd = {k: jnp.asarray(v) for k, v in train_batch(cfg, 0).items() if k != "labels"}
        fwd = put(fwd, SH.sanitize_specs(fwd, SH.batch_pspecs(fwd, dp), mesh), mesh)
        logits, _aux = jax.jit(lambda p, b: RM.forward(p, cfg, b))(pp, fwd)
        res[f"{key}/forward"] = np.asarray(logits)
        prompt = {k: jnp.asarray(v) for k, v in prompt_batch(cfg).items()}
        prompt = put(prompt, SH.sanitize_specs(prompt, SH.batch_pspecs(prompt, dp), mesh), mesh)
        logits, cache = jax.jit(lambda p, b: RM.prefill(p, cfg, b, MAX_SEQ))(pp, prompt)
        res[f"{key}/prefill"] = np.asarray(logits)
        cache = put(cache, SH.sanitize_specs(cache, SH.cache_pspecs(cache, dp), mesh), mesh)
        dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, cfg, c, t, pos))
        for t in range(DECODE):
            logits, cache = dec(pp, cache, jnp.asarray(decode_tokens(cfg, t)),
                                jnp.int32(first_pos(cfg) + t))
            res[f"{key}/decode/{t}"] = np.asarray(logits)
np.savez(out, **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel") / "ref.npz"
    run_reference(REFERENCE, out)
    return dict(np.load(out))


def init_tree(want: dict, key: str, cfg):
    """The reference's initial parameters of a case as the port's tree."""
    skeleton = TM.meta_params(cfg)
    leaves, rebuild = tree_flatten(skeleton)
    arrays = rebuild([want[f"{key}/init/{i}"] for i in range(len(leaves))])
    return params_from_arrays(arrays, cfg, device="cpu")


def cpu_mesh(grid):
    return make_mesh(grid, ("data", "model"), ["cpu"] * (grid[0] * grid[1]))


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_train_step_matches_the_reference(ref, key):
    """Two steps of make_sharded_train_step from the reference's parameters
    over the case's grid: loss, grad norm and lr within 1e-4 relative at
    each step; every parameter and both AdamW moments within 1e-5 after
    the second."""
    arch, grid = CASES[key]
    cfg = config(arch, get_smoke)
    params = init_tree(ref, key, cfg)
    opt = adamw()
    state = TrainState(params=params, opt_state=opt[0](params),
                       step=torch.zeros((), dtype=torch.int32))
    mesh = cpu_mesh(grid)
    placed = SHD.place_train_state(state, mesh)
    step = make_sharded_train_step(cfg, opt, warmup_cosine(*LR), mesh)
    for s in range(STEPS):
        placed, m = step(placed, train_batch(cfg, s))
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), ref[f"{key}/{s}/{name}"], rtol=1e-4,
                                       atol=1e-12, err_msg=f"step {s} {name}")
        assert float(m["aux_loss"]) == 0.0
    back = SHD.unplace_train_state(placed)
    assert int(back.step) == STEPS and int(back.opt_state.step) == STEPS
    for part, tree in (("params", back.params), ("m", back.opt_state.m),
                       ("v", back.opt_state.v)):
        for i, leaf in enumerate(tree_flatten(tree)[0]):
            np.testing.assert_allclose(leaf.detach().numpy(), ref[f"{key}/{part}/{i}"], rtol=0,
                                       atol=1e-5, err_msg=f"{part} {i}")


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_forward_matches_the_reference(ref, key):
    """sharded_forward of the first train batch's tokens (and a vlm's
    patches) over the case's grid: the logits, gathered over 'model',
    within 1e-5 of the reference's forward under the same specs; aux 0."""
    arch, grid = CASES[key]
    cfg = config(arch, get_smoke)
    params = init_tree(ref, key, cfg)
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg, 0).items() if k != "labels"}
    logits, aux = SHD.sharded_forward(placed, cfg, batch, mesh)
    want = ref[f"{key}/forward"]
    assert logits.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_prefill_and_decode_match_the_reference(ref, key):
    """sharded_prefill of the prompt (the cache split over 'model' along
    the sequence) and 4 sharded_decode_step s: each step's logits within
    1e-5 of the reference's GSPMD run; the cache, placed back whole, within
    1e-5 of the unsharded prefill's and decode's."""
    arch, grid = CASES[key]
    cfg = config(arch, get_smoke)
    params = init_tree(ref, key, cfg)
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    prompt = {k: torch.from_numpy(v) for k, v in prompt_batch(cfg).items()}
    logits, cache = SHD.sharded_prefill(placed, cfg, prompt, MAX_SEQ, mesh)
    np.testing.assert_allclose(logits.numpy(), ref[f"{key}/prefill"], rtol=1e-5, atol=1e-5)
    _, plain = TM.prefill(params, cfg, prompt, MAX_SEQ)
    for t in range(DECODE):
        toks = torch.from_numpy(decode_tokens(cfg, t))
        logits, cache = SHD.sharded_decode_step(placed, cfg, cache, toks, first_pos(cfg) + t,
                                                mesh)
        _, plain = TM.decode_step(params, cfg, plain, toks, first_pos(cfg) + t)
        np.testing.assert_allclose(logits.numpy(), ref[f"{key}/decode/{t}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"decode step {t}")
    whole = SHD.unplace(cache)
    for name in ("k", "v"):
        np.testing.assert_allclose(whole["l0"][name].numpy(), plain["l0"][name].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert cache["l0"][name].spec[2] == "model"


@pytest.mark.parametrize("S", [2, 4])
def test_zero1_alone_is_the_microbatched_step(S):
    """'model' 1: the sharded step's ZeRO-1 (moments split over S data
    positions, the gradient reduce-scattered, the slices gathered) against
    make_train_step with S microbatches from the same state: loss, grad
    norm and every parameter and moment within 1e-6, three steps."""
    cfg = get_smoke("granite-3-2b")
    jcfg = ref_smoke("granite-3-2b")
    assert jcfg.n_layers == cfg.n_layers
    opt = adamw()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    # placing copies the blocks: the microbatched step may update params in place
    mesh = cpu_mesh((S, 1))
    placed = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                              step=torch.zeros((), dtype=torch.int32)), mesh)
    b = TrainState(params=params, opt_state=opt[0](params), step=torch.zeros((), dtype=torch.int32))
    assert any("data" in (e if isinstance(e, tuple) else (e,))
               for pl in tree_flatten(placed.opt_state.m)[0] for e in pl.spec if e)
    sharded = make_sharded_train_step(cfg, opt, warmup_cosine(*LR), mesh)
    micro = make_train_step(cfg, opt, warmup_cosine(*LR), microbatches=S)
    for s in range(3):
        batch = train_batch(cfg, s)
        placed, got = sharded(placed, batch)
        b, want = micro(b, batch)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-6,
                                       err_msg=f"step {s} {name}")
    back = SHD.unplace_train_state(placed)
    for x, y in [*zip(tree_flatten(back.params)[0], tree_flatten(b.params)[0]),
                 *zip(tree_flatten(back.opt_state.m)[0], tree_flatten(b.opt_state.m)[0]),
                 *zip(tree_flatten(back.opt_state.v)[0], tree_flatten(b.opt_state.v)[0])]:
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=0, atol=1e-6)


def test_sharded_step_adds_each_groups_gradients_as_its_backward_ends(monkeypatch):
    """The sharded step reads a stacked block as one leaf a layer group: in
    each data block's backward every leaf's gradient is added into the sum
    once, the layer groups' last group first and each group's before the
    group below it has any (so one group's gradients are alive at a time),
    and the parameters after two steps are those of the same step whose
    sums were taken at the end (make_train_step with 2 microbatches),
    within 1e-6."""
    from repro_torch.train import loop

    cfg = dataclasses.replace(get_smoke("granite-3-2b"), n_layers=4)
    opt = adamw()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    placed = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                              step=torch.zeros((), dtype=torch.int32)),
                                   cpu_mesh((2, 2)))
    b = TrainState(params=params, opt_state=opt[0](params), step=torch.zeros((), dtype=torch.int32))
    blocks = []
    accumulating = loop._accumulating

    @contextlib.contextmanager
    def spy(flat, slots, acc):
        seen = []
        blocks.append((seen, len(slots)))
        handles = [t.register_hook(lambda g, s=s: seen.append(s)) for t, s in zip(flat, slots)]
        with accumulating(flat, slots, acc):
            yield
        for h in handles:
            h.remove()

    monkeypatch.setattr(loop, "_accumulating", spy)
    sharded = make_sharded_train_step(cfg, opt, warmup_cosine(*LR), cpu_mesh((2, 2)))
    micro = make_train_step(cfg, opt, warmup_cosine(*LR), microbatches=2)
    for s in range(2):
        placed, _ = sharded(placed, train_batch(cfg, s))
        b, _ = micro(b, train_batch(cfg, s))
    assert len(blocks) == 4
    for seen, n_slots in blocks:
        assert sorted(seen) == sorted(set(seen)) and len(seen) == n_slots
        groups = [g for _, g in seen if g is not None]
        assert groups == sorted(groups, reverse=True) and set(groups) == {0, 1, 2, 3}
    back = SHD.unplace_train_state(placed)
    for x, y in zip(tree_flatten(back.params)[0], tree_flatten(b.params)[0]):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=0, atol=1e-6)


def _count_step(cfg, grid, device="meta"):
    mesh = make_mesh(grid, ("data", "model"), [device] * (grid[0] * grid[1]))
    params = (TM.meta_params(cfg) if device == "meta" else
              TM.init_params(torch.Generator().manual_seed(0), cfg, device=device))
    opt = adamw()
    placed = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                              step=torch.zeros((), dtype=torch.int32)), mesh)
    step = make_sharded_train_step(cfg, opt, warmup_cosine(*LR), mesh, impl="torch")
    toks = torch.zeros((BATCH, SEQ), dtype=torch.long, device=device)
    with OpCounter(mesh, represent=device == "meta") as c:
        step(placed, {"tokens": toks, "labels": toks})
    # leaves whose moments ZeRO-1 splits over 'data' (others have no dimension that divides)
    zero = sum(any(e == "data" for e in pl.spec) for pl in tree_flatten(placed.opt_state.m)[0])
    return c, params, zero


def test_payloads_of_one_tiny_layer_by_hand():
    """One granite layer over (data 2, model 2), 2 rows of 16 a data block,
    float32. A position's collectives in a step: all-reduces of the
    activations (B/2, S, D) — the embedding's sum, the attention's and the
    MLP's row-parallel sums, each twice (forward and remat's recompute),
    the gradients of the three replicated inputs of column-parallel
    products (attention, MLP, head) — the loss's max (B/2, S) and its
    stacked sums (2, B/2, S), and the norm's 4 bytes; one reduce-scatter
    and one all-gather of each parameter's ZeRO-1 slice and block. No
    head is gathered (4 heads and 2 KV heads over 2)."""
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), n_layers=1)
    c, params, zero = _count_step(cfg, (2, 2))
    h = c.analysis()
    rows, d = BATCH // 2, cfg.d_model
    act = rows * SEQ * d * 4
    want_ar = 1 * act + 2 * 2 * act + 3 * act + rows * SEQ * 4 + 2 * rows * SEQ * 4 + 4
    assert h["collective_counts"]["all-reduce"] == 1 + 4 + 3 + 2 + 1
    assert h["collective_bytes"]["all-reduce"] == want_ar
    leaves = tree_flatten(params)[0]
    specs = tree_flatten(SHD.param_specs(params, make_mesh((2, 2), ("data", "model"),
                                                           ["meta"] * 4)))[0]
    split = [2 if "model" in s else 1 for s in specs]
    blocks = sum(tensor_bytes(t) // n for t, n in zip(leaves, split))
    assert h["collective_counts"]["reduce-scatter"] == len(leaves) == zero == 12
    assert h["collective_bytes"]["reduce-scatter"] == blocks // 2  # the data half of a block
    assert h["collective_counts"]["all-gather"] == len(leaves)
    assert h["collective_bytes"]["all-gather"] == blocks
    assert h["collective_counts"]["all-to-all"] == 0


def test_gathered_heads_payloads_and_positions():
    """starcoder2's 6 heads over 'model' 4 (one layer): each forward (and
    recompute) gathers q, k, v and the attention output (4 all-gathers),
    each backward reduce-scatters them (4); ZeRO-1 reduce-scatters and
    gathers each leaf whose moment has a dimension that divides by 'data'
    (16 of 20: not the 1-group column biases), and all-reduces the other
    4 leaves' gradients. Every position's flops and bytes are its own
    (position 3 runs no heads: fewer flops than 0-2), and with heads that
    divide (granite's 4 heads of 4 KV) every position's totals are equal,
    the backward pass placed by the walks' marks."""
    cfg = dataclasses.replace(config("starcoder2-3b", get_smoke), n_layers=1)
    c, params, zero = _count_step(cfg, (2, 4))
    h = c.analysis()
    n_leaves = len(tree_flatten(params)[0])
    assert (n_leaves, zero) == (20, 16)
    assert h["collective_counts"]["all-gather"] == 2 * 4 + zero
    assert h["collective_counts"]["reduce-scatter"] == 4 + zero
    assert h["collective_counts"]["all-reduce"] == 11 + n_leaves - zero
    flops = {tuple(here.values()): t["flops"] for here, t in c.position_totals()}
    assert flops[(0, 0)] == flops[(0, 1)] == flops[(1, 2)] > flops[(0, 3)] == flops[(1, 3)]
    even = dataclasses.replace(get_smoke("granite-3-2b"), n_kv_heads=4)
    c, _, _ = _count_step(even, (2, 4))
    totals = [(t["flops"], t["bytes"], t["collective_bytes"]) for _, t in c.position_totals()]
    assert all(t == totals[0] for t in totals) and totals[0][0] > 0


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-3b"])
def test_sharded_step_counts_on_meta_equal_the_cpu_counts(arch):
    """The sharded train step traced on CPU tensors (every position) and on
    meta tensors (one data block represented): every count equal."""
    cfg = config(arch, get_smoke)
    got = []
    for device in ("cpu", "meta"):
        c, _, _ = _count_step(cfg, (2, 4), device)
        h = c.analysis()
        got.append((h["flops"], h["bytes"], h["collective_bytes"], h["collective_counts"]))
        assert (c.represented > 0) == (device == "meta")
    assert got[0] == got[1]


def test_sharded_entry_points_refuse_what_they_do_not_split():
    """TaCo retrieval attention outside a decode step, and an enc-dec stack
    with TaCo attention, are refused by the train step; the moe family,
    RWKV6, the hybrid Mamba stack, whisper's encoder-decoder and TaCo decode
    run (tests/test_torch_expert_sharding.py, tests/test_torch_ssm_sharding.py,
    tests/test_torch_enc_dec_sharding.py, tests/test_torch_context_parallel.py)."""
    mesh = cpu_mesh((1, 2))
    for cfg in (dataclasses.replace(get_smoke("whisper-medium"), attention_kind="taco"),
                dataclasses.replace(get_smoke("granite-3-2b"), attention_kind="taco")):
        with pytest.raises(NotImplementedError, match="dense stack"):
            make_sharded_train_step(cfg, adamw(), warmup_cosine(*LR), mesh)
    cfg = get_smoke("granite-3-2b")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    with pytest.raises(ValueError, match="does not split"):
        SHD.sharded_forward(placed, cfg, {"tokens": torch.zeros((3, 4), dtype=torch.long)},
                            cpu_mesh((2, 1)))


@pytest.mark.parametrize("path", [("lm_head", "w"), ("blocks", "l0", "attn", "wq", "w"),
                                  ("blocks", "l0", "ffn", "down", "w")])
def test_a_whole_projection_is_refused_over_several_positions(path):
    """A projection placed whole (replicated) over 'model' 2 would have
    each position compute the whole product, and the sums count it twice:
    sharded_forward refuses it. Over 'model' 1 a whole projection is the
    position's block, and the logits equal the port's forward."""
    cfg = get_smoke("granite-3-2b")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(train_batch(cfg, 0)["tokens"])}
    for grid in ((1, 2), (1, 1)):
        mesh = cpu_mesh(grid)
        specs = SHD.param_specs(params, mesh)
        node = specs
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = P(*[None] * len(node[path[-1]]))
        placed = SHD.place(params, specs, mesh)
        if grid[1] > 1:
            with pytest.raises(NotImplementedError, match="needs"):
                SHD.sharded_forward(placed, cfg, batch, mesh)
        else:
            got, _ = SHD.sharded_forward(placed, cfg, batch, mesh)
            want, _ = TM.forward(params, cfg, batch)
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-5,
                                       atol=1e-5)
