"""The self-supervised modules against the JAX package at a small size:
``length_to_mask``/``relative_length_to_mask``, ``contrastive_loss``,
``W2VLatentExtractor``, both quantisers, ``W2VTargetQuantiser``, the span
mask, the negatives, the InfoNCE loss, BEST-RQ's loss, accuracy, shared
mask and collate function, and the fairseq shim.

Weights are drawn with numpy into the shapes of flax's variables and
carried over through ``utils/jax_bridge``. ``jax.random`` and
``torch.Generator`` draw different numbers, so the arithmetic is held on
the same draws: the test hands the same numpy arrays to the JAX module (its
``jax.random`` function patched) and to the port's draw helper
(``wav2vec._randint``/``_normal``, ``quantisers._uniform``,
``BESTRQ._uniform``/``_permutation``). The samplers themselves are held by
their invariants on the port's own draws.

Tolerances: 1e-5 absolute on outputs and gradients (float32 on both
sides, sums in another order); masks, indices and targets equal (the
random-projection targets wherever the top two cosines are more than 1e-5
apart).
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import inspect
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.dataio import dataio as jdataio
from speechbrain_tpu.lobes.models import BESTRQ as jbrq
from speechbrain_tpu.lobes.models import wav2vec as jw2v
from speechbrain_tpu.nnet import losses as jlosses
from speechbrain_tpu.nnet import quantisers as jquant
from speechbrain_tpu_torch.dataio import dataio as tdataio
from speechbrain_tpu_torch.lobes.models import BESTRQ as tbrq
from speechbrain_tpu_torch.lobes.models import wav2vec as tw2v
from speechbrain_tpu_torch.nnet import losses as tlosses
from speechbrain_tpu_torch.nnet import quantisers as tquant
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import draw_variables

ATOL = 1e-5
KEY = jax.random.PRNGKey(0)
# the extractor at a test's size: 3 layers of 16 channels over 0.5 s
EXT = dict(out_channels=(16, 16, 16), kernel_sizes=(11, 3, 3),
           strides=(5, 2, 2))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, atol=ATOL):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol)


class SameDraws:
    """The same numpy arrays for the JAX modules' ``jax.random`` calls and
    the port's draw helpers, looked up by shape."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.randint, self.uniform, self.normal = {}, {}, {}

    def add_randint(self, shape, high, seed=0):
        self.randint[tuple(shape)] = np.random.default_rng(seed).integers(
            0, high, shape).astype(np.int32)
        return self.randint[tuple(shape)]

    def add_uniform(self, shape, seed=0):
        self.uniform[tuple(shape)] = np.random.default_rng(seed).random(
            shape).astype(np.float32)
        return self.uniform[tuple(shape)]

    def add_normal(self, shape, seed=0):
        self.normal[tuple(shape)] = _x(shape, seed)
        return self.normal[tuple(shape)]

    def install(self):
        ri, un, no = self.randint, self.uniform, self.normal
        self.mp.setattr(jax.random, "randint",
                        lambda key, shape, *a, **k: jnp.asarray(ri[shape]))
        self.mp.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.asarray(
                            un[tuple(shape)]))
        self.mp.setattr(jax.random, "normal",
                        lambda key, shape=(), *a, **k: jnp.asarray(
                            no[tuple(shape)]))
        self.mp.setattr(tw2v, "_randint",
                        lambda high, shape, g, device: _t(ri[tuple(shape)])
                        .long().to(device))
        self.mp.setattr(tw2v, "_normal",
                        lambda shape, g, device: _t(no[tuple(shape)]))
        self.mp.setattr(tquant, "_uniform",
                        lambda shape, g, device: _t(un[tuple(shape)]))


@pytest.fixture
def draws(monkeypatch):
    return SameDraws(monkeypatch)


# -- length masks and the InfoNCE of similarities ----------------------------

@pytest.mark.parametrize("case", [
    ("absolute", [2, 3, 0], 4), ("absolute", [5, 1], None),
    # 0.625 * 4 = 2.5 -> 2 and 0.375 * 4 = 1.5 -> 2: half to even
    ("relative", [0.625, 0.375, 1.0], 4), ("relative", [0.5, 0.3], 7),
])
def test_length_masks_match_jax(case):
    kind, lengths, max_len = case
    if kind == "absolute":
        ours = tdataio.length_to_mask(torch.tensor(lengths), max_len=max_len,
                                      device="cpu")
        theirs = jdataio.length_to_mask(jnp.asarray(lengths), max_len=max_len)
    else:
        ours = tdataio.relative_length_to_mask(torch.tensor(lengths), max_len,
                                               dtype=torch.float32,
                                               device="cpu")
        theirs = jdataio.relative_length_to_mask(jnp.asarray(lengths),
                                                 max_len, dtype=jnp.float32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_contrastive_loss_matches_jax():
    pos, neg = _x((3, 5)), _x((3, 5, 7), seed=1)
    ours = tlosses.contrastive_loss(_t(pos), _t(neg), temperature=0.2)
    theirs = jlosses.contrastive_loss(jnp.asarray(pos), jnp.asarray(neg),
                                      temperature=0.2)
    _close(ours, theirs)


# -- the latent extractor ----------------------------------------------------

@pytest.fixture(scope="module")
def extractor_pair():
    jm = jw2v.W2VLatentExtractor(**EXT)
    wav = 0.3 * _x((2, 8000), seed=3)
    variables = draw_variables(jm, jnp.asarray(wav))
    tm = load(tw2v.W2VLatentExtractor(**EXT, device="cpu"), variables)
    return jm, jax.jit(lambda v, x: jm.apply(v, x)), variables, tm


def test_extractor_matches_jax(extractor_pair):
    """Each layer's LayerNorm at eps 1e-5, the last at flax's 1e-6, the
    waveform's population variance."""
    jm, japply, variables, tm = extractor_pair
    wav = 0.3 * _x((2, 8000), seed=4)
    theirs = japply(variables, jnp.asarray(wav))
    ours = tm(_t(wav))
    assert ours.shape == theirs.shape == (2, 398, 16)
    _close(ours, theirs)
    assert [tm.norm.eps, tm.norm_0.eps] == [1e-6, 1e-5]


def test_extractor_variables_load_every_key(extractor_pair):
    _, _, variables, tm = extractor_pair
    n_jax = sum(np.prod(a.shape) for a in
                jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert [n for n, _ in tm.named_children()][-1] == "norm"


# -- the quantisers ----------------------------------------------------------

GUMBEL = dict(dim=16, num_vars=8, groups=2, vq_dim=8)


@pytest.fixture(scope="module")
def gumbel_pair():
    jm = jquant.GumbelVectorQuantizer(**GUMBEL)
    x = jnp.asarray(_x((2, 10, 16)))
    variables = draw_variables(jm, x, train=False)
    tm = load(tquant.GumbelVectorQuantizer(**GUMBEL, device="cpu"),
              variables)
    return jm, variables, tm


@pytest.mark.parametrize("train", [False, True])
def test_gumbel_quantizer_matches_jax(gumbel_pair, draws, train):
    """Codewords, perplexity and the gradient of a weighted sum of the
    codewords and the perplexity: in training the straight-through
    gradient of the Gumbel softmax on the same uniforms."""
    jm, variables, tm = gumbel_pair
    x = _x((2, 10, 16), seed=5)
    draws.add_uniform((2 * 10 * 2, 8), seed=6)
    draws.install()
    w = _x((2, 10, 8), seed=7)

    def jloss(params):
        out = jm.apply({"params": params}, jnp.asarray(x), train=train,
                       rngs={"gumbel": KEY})
        return jnp.sum(out["x"] * w) + out["prob_perplexity"], out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    tm.zero_grad()
    out = tm(_t(x), train=train, generator=None)
    tl = (out["x"] * _t(w)).sum() + out["prob_perplexity"]
    tl.backward()
    _close(out["x"], jout["x"])
    _close(out["prob_perplexity"], jout["prob_perplexity"])
    assert out["num_vars"] == jout["num_vars"] == 16
    _close(tm.codebook.grad, jgrads["codebook"])
    _close(tm.weight_proj.weight.grad.T, jgrads["weight_proj"]["kernel"])


def test_target_quantiser_matches_jax(draws):
    jm = jw2v.W2VTargetQuantiser(in_dim=16, out_dim=8, quantiser_vars=4)
    x = _x((2, 6, 16), seed=8)
    variables = draw_variables(jm, jnp.asarray(x), train=False)
    tm = load(jw2v_target(), variables)
    draws.add_uniform((2 * 6 * 2, 4), seed=9)
    draws.install()
    for train in (False, True):
        jt, jinfo = jax.jit(lambda v, x, train=train: jm.apply(
            v, x, train=train, rngs={"gumbel": KEY}))(variables,
                                                      jnp.asarray(x))
        tt, tinfo = tm(_t(x), train=train)
        _close(tt, jt)
        _close(tinfo["prob_perplexity"], jinfo["prob_perplexity"])


def jw2v_target():
    return tw2v.W2VTargetQuantiser(in_dim=16, out_dim=8, quantiser_vars=4,
                                   device="cpu")


@pytest.mark.parametrize("size", ["small", "bestrq"])
def test_random_projection_targets_match_jax(size):
    """Targets equal wherever the top two cosines are more than 1e-5
    apart; the rest (near ties, where float32 sums in another order may
    part) are counted and must be few. ``bestrq``: the recipe's 80 mels
    into 8192 codewords of 16."""
    input_dim, cb_dim, vocab, T = {"small": (16, 8, 64, 50),
                                   "bestrq": (80, 16, 8192, 200)}[size]
    jm = jquant.RandomProjectionQuantizer(input_dim, cb_dim=cb_dim,
                                          cb_vocab=vocab)
    x = _x((2, T, input_dim), seed=10)
    variables = draw_variables(jm, jnp.asarray(x))
    tm = load(tquant.RandomProjectionQuantizer(input_dim, cb_dim, vocab,
                                               device="cpu"), variables)
    theirs = np.asarray(jm.apply(variables, jnp.asarray(x)))
    ours = tm(_t(x)).numpy()
    p = x.astype(np.float64) @ variables["params"]["P"]
    cb = variables["params"]["CB"].astype(np.float64)
    sims = (p / np.linalg.norm(p, axis=-1, keepdims=True)) @ (
        cb / np.linalg.norm(cb, axis=-1, keepdims=True)).T
    top2 = np.sort(sims, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5
    np.testing.assert_array_equal(ours[clear], theirs[clear])
    assert (~clear).sum() <= 0.01 * clear.size


def test_random_projection_buffers_are_frozen():
    """``P`` and ``CB`` are buffers: in the state dict, not parameters, so
    no optimizer holds them; a backward through the quantiser leaves them
    without a gradient; the draw is from the generator."""
    gen = torch.Generator().manual_seed(0)
    q = tquant.RandomProjectionQuantizer(16, 8, 32, device="cpu",
                                         generator=gen)
    assert list(q.state_dict()) == ["P", "CB"]
    assert list(q.parameters()) == []
    assert not q.P.requires_grad and not q.CB.requires_grad
    assert float(q.P.abs().max()) <= np.sqrt(3.0 / 16)
    same = tquant.RandomProjectionQuantizer(
        16, 8, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    assert torch.equal(q.P, same.P) and torch.equal(q.CB, same.CB)
    x = torch.randn(1, 4, 16, requires_grad=True)
    assert not q(x).requires_grad


# -- masks, negatives, InfoNCE -----------------------------------------------

def test_w2v_mask_matches_jax_on_the_same_draws(draws):
    B, T, p, L = 3, 40, 0.3, 4
    draws.add_randint((B, int(p * T / L)), T - L, seed=11)
    draws.install()
    theirs = jw2v.w2v_mask((B, T), p, L, KEY)
    ours = tw2v.w2v_mask((B, T), p, L, None, device="cpu")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("shape,p,L", [((4, 50), 0.065, 10),
                                       ((2, 9), 0.5, 10),
                                       ((3, 800), 0.065, 10)])
def test_w2v_mask_invariants(monkeypatch, shape, p, L):
    """On the port's own draws: ``max(1, int(p * T / L))`` span starts an
    utterance, each in ``[0, max(T - L, 1))``, each span ``L`` frames long
    (cut at the end), so every row holds at least one."""
    seen = []
    draw = tw2v._randint

    def record(high, size, gen, device):
        out = draw(high, size, gen, device)
        seen.append((high, size, out))
        return out

    monkeypatch.setattr(tw2v, "_randint", record)
    B, T = shape
    mask = tw2v.w2v_mask(shape, p, L, torch.Generator().manual_seed(1),
                         device="cpu")
    [(high, size, starts)] = seen
    assert size == (B, max(1, int(p * T / L))) and high == max(T - L, 1)
    assert int(starts.min()) >= 0 and int(starts.max()) < high
    assert (mask.sum(1) >= min(L, T)).all()
    for b in range(B):
        for s in starts[b].tolist():
            assert mask[b, s:s + L].all()


def test_sample_negatives_matches_jax_on_the_same_draws(draws):
    y = _x((2, 12, 5), seed=12)
    draws.add_randint((4, 2, 12), 11, seed=13)
    draws.install()
    theirs = jw2v.sample_negatives(jnp.asarray(y), 4, KEY)
    ours = tw2v.sample_negatives(_t(y), 4, None)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("T", [2, 3, 50])
def test_a_negative_is_never_its_own_frame(T):
    """On the port's own draws, each frame's negatives come from the other
    ``T - 1`` frames, every one of them reached."""
    y = torch.arange(T, dtype=torch.float32).reshape(1, T, 1).repeat(2, 1, 1)
    negs = tw2v.sample_negatives(y, 40 * T,
                                 torch.Generator().manual_seed(2))
    frame = torch.arange(T).reshape(1, 1, T)
    assert (negs[..., 0] != frame).all()
    for t in range(T):
        assert set(negs[:, 0, t, 0].long().tolist()) == set(range(T)) - {t}


def test_w2v_contrastive_loss_matches_jax():
    preds, targets = _x((2, 9, 6)), _x((2, 9, 6), seed=14)
    negs = _x((5, 2, 9, 6), seed=15)
    mask = np.random.default_rng(16).random((2, 9)) < 0.4
    ours = tw2v.w2v_contrastive_loss(_t(preds), _t(targets), _t(negs),
                                     _t(mask), temperature=0.1)
    theirs = jw2v.w2v_contrastive_loss(*map(jnp.asarray, (
        preds, targets, negs, mask)), temperature=0.1)
    _close(ours, theirs)
    # an empty mask: the mean over at least one frame, as JAX's
    zero = np.zeros_like(mask)
    _close(tw2v.w2v_contrastive_loss(_t(preds), _t(targets), _t(negs),
                                     _t(zero)),
           jw2v.w2v_contrastive_loss(*map(jnp.asarray, (
               preds, targets, negs, zero))))


# -- BEST-RQ -----------------------------------------------------------------

def test_brq_loss_and_accuracy_match_jax():
    logits = _x((2, 7, 32), seed=17)
    targets = np.random.default_rng(18).integers(0, 32, (2, 7))
    targets[0, :3] = logits[0, :3].argmax(-1)
    mask = np.random.default_rng(19).random((2, 7)) < 0.6
    args = (_t(logits), _t(targets), _t(mask))
    jargs = tuple(map(jnp.asarray, (logits, targets, mask)))
    _close(tbrq.compute_brq_loss(*args), jbrq.compute_brq_loss(*jargs))
    _close(tbrq.brq_accuracy(*args), jbrq.brq_accuracy(*jargs))


def _patch_compute_mask_draws(monkeypatch, u, perm_seed):
    """The same uniform and permutation to both compute_masks."""
    def perm(n):
        return np.random.default_rng(perm_seed).permutation(n)

    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.float32(u))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.asarray(perm(n)))
    monkeypatch.setattr(tbrq, "_uniform", lambda g: u)
    monkeypatch.setattr(tbrq, "_permutation", lambda n, g: perm(n))


@pytest.mark.parametrize("u", [0.1, 0.9])
def test_compute_mask_matches_jax_on_the_same_draws(monkeypatch, u):
    """The fraction 0.15 * 47 = 7.05 rounds up only where the uniform is
    under 0.05."""
    _patch_compute_mask_draws(monkeypatch, u, perm_seed=20)
    shape, lens = (3, 60, 80), [47, 60, 55]
    theirs = jbrq.compute_mask(shape, lens, 0.15, 4, KEY)
    ours = tbrq.compute_mask(shape, lens, 0.15, 4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("lens,p,L", [([47, 60], 0.15, 4), ([9], 0.15, 4),
                                      ([3, 5], 0.5, 4), ([400], 0.3, 2)])
def test_compute_mask_covers_aligned_slots_of_the_shortest(lens, p, L):
    """On the port's draws: whole ``L``-aligned slots of the shortest
    utterance, distinct, ``int(p * min)`` or one more of them (at least
    one), in increasing order."""
    counts = set()
    for seed in range(20):
        idx = tbrq.compute_mask((len(lens), max(lens), 8), lens, p, L,
                                torch.Generator().manual_seed(seed)).numpy()
        assert idx.dtype == np.int64 and (np.diff(idx) > 0).all()
        slots = idx.reshape(-1, L)
        assert (slots[:, 0] % L == 0).all()
        assert (slots - slots[:, :1] == np.arange(L)).all()
        assert slots[:, 0].max() < max(1, min(lens) // L) * L
        counts.add(len(slots))
    n = p * min(lens)
    assert counts <= {max(1, int(n)), max(1, int(n) + 1)}


def test_brq_mask_collate_fn_matches_jax(monkeypatch):
    _patch_compute_mask_draws(monkeypatch, 0.5, perm_seed=21)
    samples = [{"id": str(i), "sig": _x((n,), seed=i)}
               for i, n in enumerate((1600, 2400, 2000))]

    def out_len(n):
        return n // 160 + 1

    jw, jl, jm = jbrq.brq_mask_collate_fn(samples, out_len, 0.15, 2, 80, KEY)
    tw, tl, tm = tbrq.brq_mask_collate_fn(samples, out_len, 0.15, 2, 80)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # brq_mask is the span sampler's
    assert "mask_length" in inspect.signature(tbrq.brq_mask).parameters


def test_fairseq_shims_raise():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from speechbrain_tpu.lobes.models import fairseq_wav2vec as jfs
        from speechbrain_tpu_torch.lobes.models import fairseq_wav2vec as tfs
    for cls in (tfs.FairseqWav2Vec2, tfs.FairseqWav2Vec1,
                jfs.FairseqWav2Vec2, jfs.FairseqWav2Vec1):
        with pytest.raises(ImportError, match="fairseq is not installed"):
            cls("any")


# -- reference policies the port mirrors (ROADMAP Queue C) -------------------

def test_samplers_and_statistics_read_padded_frames(extractor_pair,
                                                    gumbel_pair, draws):
    """Neither package reads lengths in the SSL samplers and statistics:
    a span start and a negative may fall on padded frames; the
    extractor's mean and variance and the quantiser's perplexity include
    them. On a batch whose first utterance is half padding, both sides
    agree, and differ from the same arithmetic on the valid part."""
    _, japply, variables, tm = extractor_pair
    wav = 0.3 * _x((2, 8000), seed=22)
    wav[0, 4000:] = 0.0
    padded = tm(_t(wav))
    _close(padded, japply(variables, jnp.asarray(wav)))
    alone = tm(_t(wav[:1, :4000]))
    assert (padded[0, :alone.shape[1]] - alone[0]).abs().max() > 1e-2
    # a span start and a negative drawn in the padding, on both sides
    starts = draws.add_randint((2, 1), 30, seed=23)
    starts[0] = 28
    idx = draws.add_randint((1, 2, 40), 39, seed=24)
    idx[0, 0, 0] = 38
    jm, gvars, gm = gumbel_pair
    x = _x((2, 10, 16), seed=25)
    x[0, 5:] = 0.0
    draws.add_uniform((40, 8), seed=26)
    draws.install()
    mask = tw2v.w2v_mask((2, 40), 0.1, 10, None, device="cpu")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(
        jw2v.w2v_mask((2, 40), 0.1, 10, KEY)))
    assert mask[0, 28:38].all()
    y = _x((2, 40, 3), seed=27)
    negs = tw2v.sample_negatives(_t(y), 1, None)
    np.testing.assert_array_equal(negs.numpy(), np.asarray(
        jw2v.sample_negatives(jnp.asarray(y), 1, KEY)))
    np.testing.assert_array_equal(negs[0, 0, 0].numpy(), y[0, 39])
    ours = gm(_t(x), train=True)["prob_perplexity"]
    _close(ours, jax.jit(lambda v, x: jm.apply(
        v, x, train=True, rngs={"gumbel": KEY})["prob_perplexity"])(
            gvars, jnp.asarray(x)))
    valid = gm(_t(np.concatenate([x[:1, :5], x[1:, :5]])))
    assert abs(ours.item() - valid["prob_perplexity"].item()) > 1e-3


def test_gumbel_temperature_is_never_annealed(gumbel_pair, draws):
    """Both packages train at ``temp_tuple[0]`` unless a caller passes
    ``temp``; ``temp_tuple[1:]`` is read by neither."""
    jm, variables, tm = gumbel_pair
    assert tm.temp_tuple == tuple(jm.temp_tuple) == (2.0, 0.5, 0.999995)
    x = _x((2, 10, 16), seed=28)
    draws.add_uniform((40, 8), seed=29)
    draws.install()
    out = tm(_t(x), train=True)
    assert out["temp"] == 2.0
    _close(out["x"], tm(_t(x), train=True, temp=2.0)["x"].detach())
    jout = jm.apply(variables, jnp.asarray(x), train=True,
                    rngs={"gumbel": KEY})
    assert jout["temp"] == 2.0
    _close(out["x"], jout["x"])
