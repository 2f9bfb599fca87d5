"""Context-parallel decode in the port (``repro_torch.models.sharded``): a
one-row batch whose K/V sequence the rule table splits over the data axes
and 'model', served by every position, with TaCo retrieval attention
(``_taco_attention``) and with the recurrent mixers, against the
reference's GSPMD decode on the CPU.

The reference runs once for this module, in one subprocess with 8 forced
host devices (``run_reference``), the three cases one after the other: its
own ``repro.launch.dryrun.sharded_arch(..., dp_shards=|data|)`` of the
config, ``prefill`` of a one-row prompt (TaCo's index built there) and 4
``decode_step`` s over parameters placed by ``param_pspecs`` and the
prefilled cache placed by the sanitized ``cache_pspecs``; its prefilled
cache is saved. The port starts from the same parameters
(``params_from_arrays``) and the reference's prefilled cache, placed by the
port's own ``cache_pspecs``, and decodes the same tokens over a (data,
model) grid of CPU positions.

Cases: smoke granite-3-2b with TaCo on (data 2, model 4) (the 32 slots in 8
blocks of 4, block i at position (i // 4, i % 4); the state's mean, basis
and centroids split over 'data' along their KV heads, gathered a step),
smoke jamba-1.5-large-398b with TaCo, Mamba and 4 experts on (2, 2), and
smoke rwkv6-7b on (2, 2) (no K/V: the WKV state over the heads, the token
shifts replicated). The retrieval config (``RETRIEVAL``) selects C = 8 of
the 21-24 valid slots, so the selected slots span several positions and
the positions past ``pos`` hold none. Tolerances, float32: each decode
step's logits within 1e-5 (jamba within 1e-4, ``LOGITS_TOL``, as
``tests/test_torch_ssm_sharding.py`` holds it); the retrieved slots equal
the port's one-device decode's bit for bit.

Also: a position that holds no selected slot returns (NEG_INF, 0, 0) and
adds nothing (the merged output equals the merge without it, exactly);
the split small leaves' gather is reported; the sharded decode's counts on
meta tensors equal its counts on CPU tensors; and what stays refused
raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.mesh import make_mesh, tensor_bytes
from repro_torch.models import model as TM
from repro_torch.models import params_from_arrays
from repro_torch.models import sharded as SHD
from repro_torch.models import taco_attention as TA
from repro_torch.utils import tree_flatten
from tests.test_torch_data_parallel import run_reference

#: case -> (arch, (data, model))
CASES = {"granite/2x4": ("granite-3-2b", (2, 4)),
         "jamba/2x2": ("jamba-1.5-large-398b", (2, 2)),
         "rwkv6/2x2": ("rwkv6-7b", (2, 2))}
PROMPT, MAX_SEQ, DECODE = 20, 32, 4
#: C below the valid length, a short recent window, a small IMI
RETRIEVAL = dict(n_retrieve=8, recent_window=4, sqrt_k=4, kmeans_iters=2)
LOGITS_TOL = {"granite-3-2b": 1e-5, "rwkv6-7b": 1e-5, "jamba-1.5-large-398b": 1e-4}


def config(arch, smoke, retrieval_config):
    """The smoke config at TaCo attention where it has attention layers, as
    the long_500k cell resolves it."""
    cfg = smoke(arch)
    if cfg.mixer == "rwkv":
        return cfg
    return dataclasses.replace(cfg, attention_kind="taco",
                               retrieval=retrieval_config(**RETRIEVAL))


def prompt_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(37).integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)


def decode_tokens(cfg, t: int) -> np.ndarray:
    return np.random.default_rng(90 + t).integers(0, cfg.vocab_size, (1, 1)).astype(np.int32)


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_smoke
assert len(jax.devices()) == 8, jax.devices()
from repro.launch import sharding as SH
from repro.launch.dryrun import sharded_arch
from repro.models import model as RM
from repro.models.taco_attention import RetrievalConfig
from tests.test_torch_context_parallel import (CASES, DECODE, MAX_SEQ, PROMPT, config,
                                               decode_tokens, prompt_tokens)

out = sys.argv[1]
res = {}
dp = ("data",)


def put(tree, specs, mesh):
    return jax.device_put(tree, SH.to_named(specs, mesh))


for key, (arch, grid) in CASES.items():
    cfg = sharded_arch(config(arch, get_smoke, RetrievalConfig), False, dp_shards=grid[0])
    mesh = make_mesh(grid, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:grid[0] * grid[1]])
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        res[f"{key}/init/{i}"] = np.asarray(leaf)
    with set_mesh(mesh):
        pp = put(params, SH.sanitize_specs(params, SH.param_pspecs(params), mesh), mesh)
        _, cache = jax.jit(lambda p, b: RM.prefill(p, cfg, b, MAX_SEQ))(
            pp, {"tokens": jnp.asarray(prompt_tokens(cfg))})
        for i, leaf in enumerate(jax.tree_util.tree_leaves(cache)):
            res[f"{key}/cache/{i}"] = np.asarray(leaf)
        cache = put(cache, SH.sanitize_specs(cache, SH.cache_pspecs(cache, dp), mesh), mesh)
        dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, cfg, c, t, pos))
        for t in range(DECODE):
            toks = jnp.asarray(decode_tokens(cfg, t))
            toks = put(toks, SH.sanitize_specs(toks, SH.P(dp, None), mesh), mesh)
            logits, cache = dec(pp, cache, toks, jnp.int32(PROMPT + t))
            res[f"{key}/decode/{t}"] = np.asarray(logits)
np.savez(out, **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs of the three cases, in one subprocess."""
    out = tmp_path_factory.mktemp("context_parallel") / "ref.npz"
    run_reference(REFERENCE, out)
    return dict(np.load(out))


def port_config(key):
    return dryrun.sharded_arch(config(CASES[key][0], get_smoke, TA.RetrievalConfig), False)


def cpu_mesh(grid):
    return make_mesh(grid, ("data", "model"), ["cpu"] * (grid[0] * grid[1]))


def from_reference(ref, key, cfg):
    """(the reference's parameters, its prefilled one-row cache) as the
    port's trees."""
    leaves, rebuild = tree_flatten(TM.meta_params(cfg))
    params = params_from_arrays(rebuild([ref[f"{key}/init/{i}"] for i in range(len(leaves))]),
                                cfg, device="cpu")
    shapes = TM.init_cache(cfg, 1, MAX_SEQ, device="meta")
    leaves, rebuild = tree_flatten(shapes)
    cache = rebuild([torch.from_numpy(np.array(ref[f"{key}/cache/{i}"])).to(t.dtype)
                     for i, t in enumerate(leaves)])
    return params, cache


def placed(params, cache, mesh):
    return (SHD.place(params, SHD.param_specs(params, mesh), mesh),
            SHD.place(cache, SHD.cache_specs(cache, mesh, ("data",)), mesh))


def clone(tree):
    return TM.map_tree(lambda t: t.clone(), tree)


@pytest.fixture
def selections(monkeypatch):
    """The slots each select_slots call returns, listed under the label
    ``selections["run"]`` names."""
    seen = {"run": None}
    real = TA.select_slots

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.setdefault(seen["run"], []).append(out[0].clone())
        return out

    monkeypatch.setattr(TA, "select_slots", spy)
    return seen


@pytest.mark.parametrize("key", list(CASES))
def test_context_parallel_decode_matches_the_reference(ref, key, selections):
    """From the reference's prefilled cache placed by cache_pspecs (the
    K/V sequence over ('data', 'model')), 4 sharded_decode_step s of the
    one-row batch: each step's logits within LOGITS_TOL of the reference's
    GSPMD decode; the TaCo layers' retrieved slots equal, call for call
    and bit for bit, those of the port's one-device decode from the same
    cache."""
    arch, grid = CASES[key]
    cfg = port_config(key)
    params, cache = from_reference(ref, key, cfg)
    mesh = cpu_mesh(grid)
    pl, pc = placed(params, cache, mesh)
    if "k" in pc["l0"]:
        assert pc["l0"]["k"].spec[2] == ("data", "model")
    one = clone(cache)
    tol = LOGITS_TOL[arch]
    for t in range(DECODE):
        toks = torch.from_numpy(decode_tokens(cfg, t))
        selections["run"] = "sharded"
        logits, pc = SHD.sharded_decode_step(pl, cfg, pc, toks, PROMPT + t, mesh)
        np.testing.assert_allclose(logits.numpy(), ref[f"{key}/decode/{t}"], rtol=tol, atol=tol,
                                   err_msg=f"decode step {t}")
        selections["run"] = "one"
        want, one = TM.decode_step(params, cfg, one, toks, PROMPT + t)
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=tol, atol=tol)
    got, base = selections.get("sharded", []), selections.get("one", [])
    layers = sum(s["mixer"] == "attn" for s in cfg.layer_specs()) * cfg.n_groups
    assert len(got) == len(base) == (DECODE * layers if cfg.attention_kind == "taco" else 0)
    for i, (a, b) in enumerate(zip(got, base)):
        assert torch.equal(a, b), f"selection {i}"
    if got:
        assert got[0].shape[-1] == RETRIEVAL["n_retrieve"] < PROMPT


def test_the_one_row_cache_is_split_over_every_position(ref):
    """granite's cache on (2, 4): K/V blocks of 4 slots keyed by (data,
    model), block i holding slots [4i, 4i + 4) at position (i // 4,
    i % 4) (the spec's first axis the major one); the cells replicated;
    one decode step writes the new token into the block that owns its
    position only, and its cell into the one copy of ``cells``."""
    cfg = port_config("granite/2x4")
    params, cache = from_reference(ref, "granite/2x4", cfg)
    mesh = cpu_mesh((2, 4))
    pl, pc = placed(params, cache, mesh)
    k = pc["l0"]["k"]
    assert sorted(k.blocks) == [(d, m) for d in range(2) for m in range(4)]
    for (d, m), blk in k.blocks.items():
        np.testing.assert_array_equal(blk.numpy(), cache["l0"]["k"][
            :, :, 4 * (4 * d + m):4 * (4 * d + m + 1)].numpy())
    assert len(pc["l0"]["taco"].cells.blocks) == 1
    before = {key: blk.clone() for key, blk in k.blocks.items()}
    sizes = pc["l0"]["taco"].cell_sizes.blocks[()].clone()
    SHD.sharded_decode_step(pl, cfg, pc, torch.from_numpy(decode_tokens(cfg, 0)), PROMPT, mesh)
    owner = divmod(PROMPT // 4, 4)
    for key, blk in k.blocks.items():
        changed = ~torch.isclose(blk, before[key]).all(dim=(-1, -2))  # (g, 1, 4) slots
        assert changed.any().item() == (key == owner), key
        if key == owner:
            assert changed[:, :, PROMPT % 4].all() and changed.sum() == changed.shape[0]
    cells = pc["l0"]["taco"].cells.blocks[()]
    np.testing.assert_array_equal(cells[..., :PROMPT].numpy(),
                                  cache["l0"]["taco"].cells[..., :PROMPT].numpy())
    grown = pc["l0"]["taco"].cell_sizes.blocks[()] - sizes  # one count a (group, head, subspace)
    assert grown.flatten(-2).sum(-1).eq(1).all()
    assert ((cells[..., PROMPT] >= 0) & (cells[..., PROMPT] < RETRIEVAL["sqrt_k"] ** 2)).all()


def test_a_position_without_selected_slots_adds_nothing(ref, monkeypatch):
    """granite's first decode step on (2, 4) at pos 20: the blocks of slots
    24-31 (positions (1, 2) and (1, 3)) hold no valid slot, so none is
    selected there. Their parts are (NEG_INF, 0, 0) exactly, every part's
    max finite (nothing reduced over an empty set), and the merged output
    equals, bit for bit, the merge of the parts that hold slots."""
    cfg = port_config("granite/2x4")
    params, cache = from_reference(ref, "granite/2x4", cfg)
    mesh = cpu_mesh((2, 4))
    pl, pc = placed(params, cache, mesh)
    merges = []
    real = SHD.lse_combine

    def spy(parts):
        out = real(parts)
        merges.append((parts, out))
        return out

    monkeypatch.setattr(SHD, "lse_combine", spy)
    SHD.sharded_decode_step(pl, cfg, pc, torch.from_numpy(decode_tokens(cfg, 0)), PROMPT, mesh)
    assert len(merges) == cfg.n_layers
    for parts, out in merges:
        assert len(parts) == 8
        empty = [i for i, (mx, den, num) in enumerate(parts) if not den.any()]
        assert {6, 7} <= set(empty) and len(empty) < 8
        for i in empty:
            mx, den, num = parts[i]
            assert (mx == TA.NEG_INF).all() and not num.any()
        assert all(torch.isfinite(mx).all() for mx, _, _ in parts)
        kept = [p for i, p in enumerate(parts) if i not in empty]
        assert torch.equal(real(kept), out)


def test_the_split_state_is_gathered_and_reported():
    """One TaCo decode step of granite's smoke config (2 layers) on (2, 4):
    besides the gathers of q, k, v (a layer) and of the logits, each layer
    all-gathers the state's mean, basis and centroids (split over 'data'
    along their 2 KV heads) whole, once; the partial softmax sums are one
    all-reduce a layer over all 8 positions."""
    cfg = port_config("granite/2x4")
    mesh = cpu_mesh((2, 4))
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    pl = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    cache = SHD.sharded_init_cache(cfg, 1, MAX_SEQ, mesh)
    st = cache["l0"]["taco"]
    assert all(x.spec[1] == "data" for x in (st.mean, st.basis, st.centroids))
    with OpCounter(mesh) as c:
        SHD.sharded_decode_step(pl, cfg, cache, torch.zeros((1, 1), dtype=torch.long), 5, mesh)
    h = c.analysis()
    layers, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    state = sum(tensor_bytes(x.blocks[(0,)]) * 2 // layers for x in (st.mean, st.basis,
                                                                  st.centroids))
    qkv = (cfg.n_heads + 2 * kv) * hd * 4
    assert h["collective_counts"]["all-gather"] == layers * (3 + 3) + 1
    assert h["collective_bytes"]["all-gather"] == layers * (qkv + state) + cfg.vocab_size * 4


@pytest.mark.parametrize("key", list(CASES))
def test_context_parallel_counts_on_meta_equal_the_cpu_counts(key):
    """Two sharded decode steps of the one-row batch over the case's grid,
    traced on CPU tensors (every position) and on meta tensors (one
    representative of the positions' blocks): flops, bytes, payloads and
    counts equal."""
    _arch, grid = CASES[key]
    cfg = port_config(key)
    got = []
    for device in ("cpu", "meta"):
        mesh = make_mesh(grid, ("data", "model"), [device] * (grid[0] * grid[1]))
        params = (TM.meta_params(cfg) if device == "meta" else
                  TM.init_params(torch.Generator().manual_seed(0), cfg, device=device))
        pl = SHD.place(params, SHD.param_specs(params, mesh), mesh)
        cache = SHD.sharded_init_cache(cfg, 1, MAX_SEQ, mesh,
                                       device="meta" if device == "meta" else None)
        toks = torch.zeros((1, 1), dtype=torch.long, device=device)
        with OpCounter(mesh, represent=device == "meta") as c:
            for t in range(2):
                SHD.sharded_decode_step(pl, cfg, cache, toks, PROMPT + t, mesh)
        h = c.analysis()
        got.append((h["flops"], h["bytes"], h["collective_bytes"], h["collective_counts"]))
        if device == "meta" and cfg.attention_kind == "taco":
            assert c.represented > 0
    assert got[0] == got[1]
    assert got[0][1] > 0 and got[0][3]["all-reduce"] > 0


def test_what_stays_refused_raises():
    """TaCo's prefill and train step stay on one device, a (B,) position
    has no TaCo decode, and a one-row batch over a cache split over 'model'
    alone (the data positions holding copies) is refused."""
    cfg = port_config("granite/2x4")
    mesh = cpu_mesh((2, 4))
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    pl = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    with pytest.raises(NotImplementedError, match="outside a decode step"):
        SHD.sharded_prefill(pl, cfg, {"tokens": torch.zeros((2, 4), dtype=torch.long)}, 8, mesh)
    cache = SHD.sharded_init_cache(cfg, 1, MAX_SEQ, mesh)
    with pytest.raises(ValueError, match="one scalar pos"):
        SHD.sharded_decode_step(pl, cfg, cache, torch.zeros((1, 1), dtype=torch.long),
                                torch.tensor([3]), mesh)
    full = dataclasses.replace(cfg, attention_kind="full")
    shapes = TM.init_cache(full, 1, MAX_SEQ, device="cpu")
    specs = SHD.cache_specs(shapes, mesh, ("data",))
    for layer in specs.values():
        for name in ("k", "v"):
            layer[name] = SHD.P(None, None, "model", None, None)
    with pytest.raises(ValueError, match="does not split"):
        SHD.sharded_decode_step(pl, full, SHD.place(shapes, specs, mesh),
                                torch.zeros((1, 1), dtype=torch.long), 3, mesh)
