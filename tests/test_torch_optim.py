"""The port's optimizers, clipping, schedules, loss and token stream
(``repro_torch.optim``, ``train.losses``, ``data.tokens``) against
``repro``'s, fed the same numpy inputs.

Tolerance: 1e-6 relative (plus an absolute floor of 1e-6 times the
largest magnitude of the compared array, for entries that cancel to near
zero). Both sides compute in float32 in the same order, so what is left is
a rounding of XLA's fusions or of the transcendental functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.data.tokens import SyntheticTokenStream as JStream
from repro.train.losses import IGNORE as J_IGNORE
from repro.train.losses import cross_entropy as j_cross_entropy
from repro_torch import optim
from repro_torch.data import SyntheticTokenStream
from repro_torch.optim.adafactor import Leaf
from repro_torch.train import IGNORE, cross_entropy
from repro_torch.utils import tree_flatten, tree_map

SHAPES = {"blocks": {"w": (3, 5, 7), "scale": (3, 5)}, "head": {"w": (5, 11)}, "bias": (7,)}


def close(got, want, rtol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    floor = 1e-6 * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def close_trees(got, want):
    got_l, want_l = tree_flatten(got)[0], tree_flatten(want)[0]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        close(g, w)


def _tree(rng, scale=1.0):
    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)
    return draw(SHAPES)


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_and_states_match_over_five_steps(name):
    """Each step: the same numpy gradients into both; updates and every
    state leaf within 1e-6; the parameters move by the updates."""
    rng = np.random.default_rng(0)
    params_np = _tree(rng)
    kw = dict(weight_decay=0.1) if name == "adamw" else dict(weight_decay=0.05)
    jinit, jupdate = getattr(joptim, name)(**kw)
    init, update = getattr(optim, name)(**kw)
    jp = _to(params_np, jnp.asarray)
    tp = _to(params_np, torch.tensor)
    jstate, state = jinit(jp), init(tp)
    for step in range(5):
        g = _tree(rng, scale=10.0 ** (step - 2))
        lr = 1e-3 * (step + 1)
        jup, jstate = jupdate(_to(g, jnp.asarray), jstate, jp, jnp.float32(lr))
        up, state = update(_to(g, torch.tensor), state, tp, torch.tensor(lr))
        close_trees(up, jup)
        assert int(state.step) == int(jstate.step) == step + 1
        if name == "adamw":
            close_trees(state.m, jstate.m)
            close_trees(state.v, jstate.v)
        else:
            close_trees(state.vr, jstate.vr)
            close_trees(state.vc, jstate.vc)
        jp = jax.tree.map(lambda p, u: p + u, jp, jup)
        tp = tree_map(lambda p, u: p + u, tp, up)
        close_trees(tp, jp)


class _Halves(Leaf):
    """A leaf as two blocks along its dimension ``dim``, as a step that
    splits the parameter hands it to Adafactor: the blocks' partial sums
    added where a mean runs over ``dim``; a factor that does not have
    ``dim`` is read whole by both blocks and written by the first."""

    def __init__(self, g, p, vr, vc, dim):
        super().__init__(g, p, vr, vc)
        self.dim = dim % p.dim()
        self.out = torch.empty_like(p)
        dims = list(range(p.dim()))
        factored = p.dim() >= 2
        self.factor_dims = (dims[:-1] if factored else dims,
                            dims[:-2] + dims[-1:] if factored else [])

    def each(self, fn):
        return [fn(0), fn(1)]

    def add(self, parts, dim):
        if dim is None or dim % len(self.shape) == self.dim:
            return [parts[0] + parts[1]] * 2
        return parts

    def grad(self, i):
        return self.g.chunk(2, self.dim)[i].to(torch.float32, copy=True)

    def factors(self, i):
        out = []
        for v, dims in zip((self.vr, self.vc), self.factor_dims):
            split = self.dim in dims
            out.append((v.chunk(2, dims.index(self.dim))[i] if split else v, split or i == 0))
        (vr, own_r), (vc, own_c) = out
        return vr, vc, own_r, own_c

    def param(self, i):
        return self.p.chunk(2, self.dim)[i]

    def apply(self, i, u):
        self.out.chunk(2, self.dim)[i].copy_(u.to(self.p.dtype))


@pytest.mark.parametrize("shape, dim", [((3, 6, 8), -1), ((3, 6, 8), -2), ((4, 6, 8), 0),
                                        ((8,), 0)])
def test_adafactor_over_split_leaves_equals_the_whole_update(shape, dim):
    """Adafactor's one copy of its arithmetic (``adafactor.leaf_update``)
    over a parameter in two blocks along its last, second-to-last or
    leading dimension (or a vector's), the means over the split dimension
    taken as the blocks' partial sums: three steps of updates and factors
    within 1e-6 of the whole parameter's."""
    rng = np.random.default_rng(4)
    init, update = optim.adafactor(weight_decay=0.05)
    p = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    whole, split = init({"w": p}), init({"w": p})
    for step in range(3):
        g = torch.tensor((rng.standard_normal(shape) * 10.0 ** (step - 1)).astype(np.float32))
        lr = torch.tensor(1e-3 * (step + 1))
        want, whole = update({"w": g}, whole, {"w": p}, lr)
        leaf = _Halves(g, p, split.vr["w"], split.vc["w"], dim)
        got, split = update(None, split, None, lr, leaves=[leaf])
        assert got is None and int(split.step) == int(whole.step) == step + 1
        close(leaf.out, want["w"].numpy())
        close(split.vr["w"], whole.vr["w"].numpy())
        close(split.vc["w"], whole.vc["w"].numpy())


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm(max_norm):
    """Clipped (norm above max_norm) and left alone (below it)."""
    g = _tree(np.random.default_rng(1))
    jg, jn = joptim.clip_by_global_norm(_to(g, jnp.asarray), max_norm)
    tg, tn = optim.clip_by_global_norm(_to(g, torch.tensor), max_norm)
    close(tn, jn)
    close(optim.global_norm(_to(g, torch.tensor)), joptim.global_norm(_to(g, jnp.asarray)))
    close_trees(tg, jg)


def test_schedules():
    jfn, fn = joptim.warmup_cosine(3e-4, 20, 100), optim.warmup_cosine(3e-4, 20, 100)
    for step in (0, 1, 7, 19, 20, 21, 55, 99, 100, 150):
        close(fn(torch.tensor(step, dtype=torch.int32)), jfn(jnp.int32(step)))
    close(optim.constant_lr(2e-4)(3), joptim.constant_lr(2e-4)(3))


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [0.0, 0.3, 1.0])
def test_cross_entropy(z_loss, masked):
    """Ignore-index masking (none, some, all labels) with and without the
    z-loss."""
    assert IGNORE == J_IGNORE
    rng = np.random.default_rng(int(masked * 10))
    logits = (rng.standard_normal((3, 5, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 5)).astype(np.int32)
    labels[rng.random((3, 5)) < masked] = IGNORE
    want = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    got = cross_entropy(torch.tensor(logits), torch.tensor(labels), z_loss=z_loss)
    close(got, want)


@pytest.mark.parametrize("seed,shard", [(0, 0), (3, 1), (11, 5)])
def test_token_stream_batches_are_identical(seed, shard):
    want = JStream(512, 33, 4, seed=seed, shard=shard, num_shards=8)
    got = SyntheticTokenStream(512, 33, 4, seed=seed, shard=shard, num_shards=8)
    for step in (0, 1, 17):
        a, b = got.batch(step), want.batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for key in a:
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
    first = next(iter(got))
    np.testing.assert_array_equal(first["tokens"], want.batch(0)["tokens"])
