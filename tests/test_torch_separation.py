"""The separation modules against the JAX package at a tiny width, the
same numpy inputs through both, the JAX weights (drawn with numpy into
the shapes of flax's variables) carried over by ``utils/jax_bridge``:

* ``GroupNorm`` on 3-D and 4-D inputs, ``ConvTranspose1d`` (grouped,
  strided, dilated, padded), ``overlap_and_add``, ``spectral_magnitude``;
* ``cal_si_snr`` with relative lengths that round at .5, ``cal_snr``,
  ``PitWrapper`` at 2 and 3 speakers with the chosen permutations (ties
  included) and ``reorder_tensor``, ``get_si_snr_with_pitwrapper``;
* ``ReduceLROnPlateau`` across ``dont_halve_until_epoch`` and
  ``patience``, saved by one package and loaded by the other;
* the dual-path chunking at odd and even lengths and at every ``gap``;
  ``SepformerWrapper`` in its three ``block_type``s and with its options,
  its loss and every gradient of a training step;
* ``MemLSTM`` in each ``mem_type``, both ways; ``RESepformerWrapper``
  (RE-SepFormer and SkiM); the causal ``ResourceEfficientSeparator``;
* ``ConvTasNetWrapper`` (gLN, cLN, causal, softmax masks), the binaural
  wrapper in its three modes, and the ``cross`` mode's ILD resize
  against ``jax.image.resize`` up and down;
* ``SepformerSeparation``: both ``separate_batch`` compositions and
  ``separate_file`` against the JAX interface.

Tolerance: 1e-5 relative L2 in float32 (outputs, losses), 1e-4 for the
whole gradient; permutations equal."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.inference.separation import (
    SepformerSeparation as JaxSepformerSeparation,
)
from speechbrain_tpu.lobes.models import conv_tasnet as jct
from speechbrain_tpu.lobes.models import dual_path as jdp
from speechbrain_tpu.lobes.models import resepformer as jrs
from speechbrain_tpu.nnet import losses as jlosses
from speechbrain_tpu.nnet.CNN import ConvTranspose1d as JaxConvT
from speechbrain_tpu.nnet.normalization import GroupNorm as JaxGroupNorm
from speechbrain_tpu.nnet.schedulers import (
    ReduceLROnPlateau as JaxPlateau,
)
from speechbrain_tpu.processing import features as jfeatures
from speechbrain_tpu.processing import signal_processing as jsp
from speechbrain_tpu_torch.dataio.dataio import write_audio
from speechbrain_tpu_torch.inference.separation import SepformerSeparation
from speechbrain_tpu_torch.lobes.models import conv_tasnet as tct
from speechbrain_tpu_torch.lobes.models import dual_path as tdp
from speechbrain_tpu_torch.lobes.models import resepformer as trs
from speechbrain_tpu_torch.nnet import losses as tlosses
from speechbrain_tpu_torch.nnet.CNN import Conv1d, ConvTranspose1d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import GroupNorm
from speechbrain_tpu_torch.nnet.schedulers import ReduceLROnPlateau
from speechbrain_tpu_torch.processing import features as tfeatures
from speechbrain_tpu_torch.processing import signal_processing as tsp
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import _jax, _t, _x, draw_from_shapes, draw_variables

RTOL = 1e-5
GRAD_RTOL = 1e-4


def _rel(a, b, rtol=RTOL, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.linalg.norm(a - b)
    assert err <= rtol * max(np.linalg.norm(b), 1e-30), (
        what, err, np.linalg.norm(b))


def _pair(jm, tm, *args, seed=3, **kwargs):
    """Variables drawn for ``jm``, loaded into ``tm``; returns them."""
    variables = draw_variables(jm, *map(jnp.asarray, args), seed=seed,
                               **kwargs)
    load(tm, variables)
    return variables


def _jrun(jm, variables, *args, **kwargs):
    return jax.jit(lambda v, *a: jm.apply(v, *a, **kwargs))(
        _jax(variables), *map(jnp.asarray, args))


def _check(jm, tm, *args, rtol=RTOL, **kwargs):
    """The port's eval-mode output against JAX's on ``args`` (numpy)."""
    variables = _pair(jm, tm, *args, **kwargs)
    ref = _jrun(jm, variables, *args, **kwargs)
    with torch.no_grad():
        out = tm.eval()(*map(_t, args))
    _rel(out, ref, rtol, what=type(tm).__name__)
    return variables


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("shape,groups", [((2, 9, 8), 1), ((2, 5, 3, 8), 1),
                                          ((2, 9, 8), 4)],
                         ids=["3d", "4d", "groups4"])
def test_group_norm_matches_flax(shape, groups):
    x = 3.0 + _x(shape, seed=1)
    _check(JaxGroupNorm(num_groups=groups, eps=1e-8),
           GroupNorm(shape[-1], num_groups=groups, eps=1e-8, device="cpu"), x)


@pytest.mark.parametrize("in_ch,out_ch,kw", [
    (16, 1, dict(kernel_size=16, stride=8)),
    (6, 4, dict(kernel_size=5, stride=2, padding=1, output_padding=1)),
    (4, 6, dict(kernel_size=3, stride=1, dilation=2, groups=2)),
    (6, 9, dict(kernel_size=4, stride=2, groups=3, padding=1)),
], ids=["decoder", "padded", "dilated_groups2", "strided_groups3"])
def test_conv_transpose1d_matches_jax(in_ch, out_ch, kw):
    x = _x((2, 11, in_ch), seed=2)
    tm = ConvTranspose1d(out_ch, in_channels=in_ch, device="cpu", **kw)
    _check(JaxConvT(out_channels=out_ch, **kw), tm, x)


def test_overlap_and_add_matches_jax():
    frames = _x((2, 3, 7, 16), seed=4)
    _rel(tsp.overlap_and_add(_t(frames), 8),
         jsp.overlap_and_add(jnp.asarray(frames), 8))
    _rel(tsp.overlap_and_add(_t(frames), 5),
         jsp.overlap_and_add(jnp.asarray(frames), 5))


@pytest.mark.parametrize("power,log", [(1, False), (0.5, False), (0.5, True)])
def test_spectral_magnitude_matches_jax(power, log):
    pair = _x((2, 5, 9, 2), seed=5)
    cplx = pair[..., 0] + 1j * pair[..., 1]
    for arr, tarr in ((pair, _t(pair)),
                      (cplx.astype(np.complex64),
                       torch.from_numpy(cplx.astype(np.complex64)))):
        _rel(tfeatures.spectral_magnitude(tarr, power=power, log=log),
             jfeatures.spectral_magnitude(jnp.asarray(arr), power=power,
                                          log=log))


# -- losses ------------------------------------------------------------------

# T = 8: 0.5625 * 8 = 4.5 rounds to 4 and 0.6875 * 8 = 5.5 to 6 (half to
# even); 0.3125 * 8 = 2.5 to 2
LENS = np.array([1.0, 0.5625, 0.6875, 0.3125], np.float32)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_si_snr_and_snr_match_jax(with_lengths):
    src = _x((4, 8, 3), seed=6)
    est = src + 0.3 * _x((4, 8, 3), seed=7)
    lens = LENS if with_lengths else None
    ours = tlosses.cal_si_snr(_t(src), _t(est),
                              None if lens is None else _t(lens))
    theirs = jlosses.cal_si_snr(jnp.asarray(src), jnp.asarray(est),
                                None if lens is None else jnp.asarray(lens))
    _rel(ours, theirs)
    _rel(tlosses.cal_snr(_t(src), _t(est)),
         jlosses.cal_snr(jnp.asarray(src), jnp.asarray(est)))


def test_si_snr_mask_rounds_half_to_even():
    """A sample that lies past round(len * T) changes nothing."""
    src, est = _x((4, 8, 1), seed=8), _x((4, 8, 1), seed=9)
    base = tlosses.cal_si_snr(_t(src), _t(est), _t(LENS))
    counts = [8, 4, 6, 2]
    for b, n in enumerate(counts):
        changed = est.copy()
        changed[b, n:] += 5.0
        again = tlosses.cal_si_snr(_t(src), _t(changed), _t(LENS))
        assert torch.equal(again, base)
        changed[b, n - 1] += 5.0
        assert not torch.equal(
            tlosses.cal_si_snr(_t(src), _t(changed), _t(LENS))[b], base[b])


@pytest.mark.parametrize("n_src", [2, 3])
def test_pit_matches_jax_with_permutations(n_src):
    rng = np.random.default_rng(10)
    src = _x((5, 40, n_src), seed=11)
    perms = [rng.permutation(n_src) for _ in range(5)]
    est = np.stack([src[b][:, p] for b, p in enumerate(perms)])
    est = est + 0.05 * _x(est.shape, seed=12)
    # the last row's sources, and its estimates, are equal: every
    # permutation ties exactly, and the first wins
    src[-1] = src[-1, :, :1]
    est[-1] = src[-1, :, :1] + 0.05 * _x((40, 1), seed=13)
    base = lambda t, e: -tlosses.cal_si_snr(t, e)  # noqa: E731
    pit = tlosses.PitWrapper(base)
    loss, chosen = pit(_t(est), _t(src))
    jloss, jchosen = jlosses.PitWrapper(
        lambda t, e: -jlosses.cal_si_snr(t, e))(jnp.asarray(est),
                                                 jnp.asarray(src))
    _rel(loss, jloss)
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jchosen))
    for b in range(4):
        assert np.argsort(perms[b]).tolist() == chosen[b].tolist()
    assert chosen[-1].tolist() == list(range(n_src))
    reordered = pit.reorder_tensor(_t(est), chosen)
    jreordered = jlosses.PitWrapper(None).reorder_tensor(jnp.asarray(est),
                                                         jchosen)
    _rel(reordered, jreordered)
    _rel(tlosses.get_si_snr_with_pitwrapper(_t(src), _t(est)),
         jlosses.get_si_snr_with_pitwrapper(jnp.asarray(src),
                                            jnp.asarray(est)))


def test_pit_si_snr_gradient_matches_jax():
    src, est = _x((3, 40, 2), seed=14), _x((3, 40, 2), seed=15)
    lens = np.array([1.0, 0.8, 0.5], np.float32)
    t_est = _t(est).requires_grad_(True)
    tlosses.get_si_snr_with_pitwrapper(_t(src), t_est, _t(lens)).mean() \
        .backward()
    jgrad = jax.grad(lambda e: jnp.mean(jlosses.get_si_snr_with_pitwrapper(
        jnp.asarray(src), e, jnp.asarray(lens))))(jnp.asarray(est))
    _rel(t_est.grad, jgrad, GRAD_RTOL)


# -- scheduler ---------------------------------------------------------------

LOSSES = [5.0, 4.0, 4.5, 3.0, 3.5, 3.6, 3.7, 3.8, 2.0, 2.5, 2.6, 2.7]


@pytest.mark.parametrize("patience,until", [(2, 3), (0, 0), (1, 5)])
def test_reduce_lr_on_plateau_matches_jax_and_resumes(patience, until,
                                                      tmp_path):
    """The same rates epoch by epoch; halfway through, each package's
    state is saved and loaded into the other's, and both go on alike."""
    tsch = ReduceLROnPlateau(factor=0.5, patience=patience,
                             dont_halve_until_epoch=until)
    jsch = JaxPlateau(factor=0.5, patience=patience,
                      dont_halve_until_epoch=until)
    tlr = jlr = 1.0
    rates = []
    for epoch, loss in enumerate(LOSSES, start=1):
        if epoch == 7:
            tsch._save(tmp_path / "t.json")
            jsch._save(tmp_path / "j.json")
            tsch, jsch = (
                ReduceLROnPlateau(factor=0.5, patience=patience,
                                  dont_halve_until_epoch=until),
                JaxPlateau(factor=0.5, patience=patience,
                           dont_halve_until_epoch=until))
            tsch._load(tmp_path / "j.json")
            jsch._load(tmp_path / "t.json")
        _, tlr = tsch(tlr, epoch, loss)
        _, jlr = jsch(jlr, epoch, loss)
        assert tlr == jlr, epoch
        rates.append(tlr)
    assert tsch.losses == jsch.losses and tsch.anchor == jsch.anchor
    assert tsch.patience_counter == jsch.patience_counter
    assert min(rates) < 1.0 or until >= len(LOSSES)


# -- dual path ---------------------------------------------------------------

@pytest.mark.parametrize("T", [37, 40, 36, 44], ids=lambda t: f"T{t}")
def test_segment_and_overlap_add_match_jax(T):
    """K = 8: T = 37 and 40 give gaps 7 and 4; T = 36 and 44 make
    (K/2 + T % K) % K zero, where the formula pads a whole chunk (gap
    K)."""
    jm = jdp.DualPathModel(in_channels=4, out_channels=4, intra_model=None,
                           inter_model=None, K=8)
    x = _x((2, T, 4), seed=16)
    jsegs, jgap = jm._segment(jnp.asarray(x), 8)
    segs, gap = tdp.segment(_t(x), 8)
    assert gap == jgap and 1 <= gap <= 8
    _rel(segs, jsegs)
    y = _x(tuple(segs.shape), seed=17)
    for g in (gap, 0, 3):
        _rel(tdp.overlap_add(_t(y), g), jm._overlap_add(jnp.asarray(y), g))
    # overlap_add(segment(x)) is each frame counted twice
    _rel(tdp.overlap_add(segs, gap), 2 * x)


SEP = dict(encoder_kernel_size=8, encoder_out_nchannels=16,
           masknet_chunksize=8, masknet_numlayers=2, intra_numlayers=1,
           inter_numlayers=1, intra_nhead=2, inter_nhead=2, intra_dffn=32,
           inter_dffn=32)
SEP_CASES = {
    "transformer": {},
    "rnn": dict(block_type="rnn", rnn_hidden=8),
    "conformer_intra": dict(block_type="conformer_intra",
                            conformer_kernel_size=3),
    "options": dict(masknet_useextralinearlayer=True,
                    masknet_extraskipconnection=False, masknet_numspks=3,
                    intra_norm_before=False, intra_use_positional=False),
}


@pytest.mark.parametrize("T", [1001, 1200], ids=["odd", "even"])
@pytest.mark.parametrize("case", list(SEP_CASES))
def test_sepformer_wrapper_matches_jax(case, T):
    cfg = dict(SEP, **SEP_CASES[case])
    _check(jdp.SepformerWrapper(**cfg),
           tdp.SepformerWrapper(device="cpu", **cfg), _x((2, T), seed=18),
           train=False)


def test_conformer_intra_block_trains_from_its_initialisation():
    """C46: at the YAML's depth (8 layers), an all-padding chunk stays
    exactly zero through JAX's Conformer intra block at flax's zero
    biases, and each LayerNorm's backward over a zero row scales the
    gradient by 1/sqrt(1e-5): the first gradient is not finite. The
    port's block draws its biases non-zero and its gradient is."""
    x = _x((2, 250, 16), seed=31)
    x[1] = 0.0  # the last chunk of a mixture: all padding
    r = _x(x.shape, seed=32)
    jm = jdp.SBConformerEncoderBlock(num_layers=8, d_model=16, nhead=2,
                                     d_ffn=32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    grads = jax.grad(lambda v: jnp.sum(jm.apply(v, jnp.asarray(x)) * r))(
        variables)
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree_util.tree_leaves(grads))
    torch.manual_seed(0)
    tm = tdp.SBConformerEncoderBlock(num_layers=8, d_model=16, nhead=2,
                                     d_ffn=32, device="cpu")
    (tm(_t(x)) * _t(r)).sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in tm.parameters())
    biased = [m for m in tm.modules() if isinstance(m, (Linear, Conv1d))
              and m.bias is not None]
    assert biased and all(float(m.bias.detach().abs().min()) > 0
                          for m in biased)


def test_dual_path_model_with_global_positions_matches_jax():
    intra = dict(num_layers=1, d_model=16, nhead=2, d_ffn=32)
    jm = jdp.DualPathModel(
        in_channels=16, out_channels=16,
        intra_model=jdp.SBTransformerBlock(**intra),
        inter_model=jdp.SBTransformerBlock(**intra), num_layers=1, K=6,
        use_global_pos_enc=True, max_length=500)
    tm = tdp.DualPathModel(
        16, 16, tdp.SBTransformerBlock(device="cpu", **intra),
        tdp.SBTransformerBlock(device="cpu", **intra), num_layers=1, K=6,
        use_global_pos_enc=True, max_length=500, device="cpu")
    _check(jm, tm, _x((2, 31, 16), seed=19), train=False)


def test_sepformer_training_step_matches_jax():
    """PIT SI-SNR of a training-mode forward (dropout 0): the loss and
    every parameter's gradient."""
    jm = jdp.SepformerWrapper(**SEP)
    tm = tdp.SepformerWrapper(device="cpu", **SEP)
    mix, src = _x((2, 900), seed=20), _x((2, 900, 2), seed=21)
    lens = np.array([1.0, 0.7], np.float32)
    variables = _pair(jm, tm, mix, train=False)

    def loss_fn(p):
        est = jm.apply({"params": p}, jnp.asarray(mix), train=True)
        return jnp.mean(jlosses.get_si_snr_with_pitwrapper(
            jnp.asarray(src), est, jnp.asarray(lens)))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        _jax(variables["params"]))
    loss = tlosses.get_si_snr_with_pitwrapper(
        _t(src), tm.train()(_t(mix)), _t(lens)).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=RTOL)
    ref = tdp.SepformerWrapper(device="cpu", **SEP)
    load(ref, {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    theirs = dict(ref.named_parameters())
    names = [n for n, _ in tm.named_parameters()]
    _rel(torch.cat([p.grad.reshape(-1) for _, p in tm.named_parameters()]),
         torch.cat([theirs[n].detach().reshape(-1) for n in names]).numpy(),
         GRAD_RTOL, what="gradients")


# -- RE-SepFormer / SkiM -----------------------------------------------------

@pytest.mark.parametrize("bidirectional", [False, True], ids=["causal", "bi"])
@pytest.mark.parametrize("mem_type", ["hc", "h", "c", "id"])
def test_mem_lstm_matches_jax(mem_type, bidirectional):
    d, S, B, H = (2 if bidirectional else 1), 5, 2, 6
    h, c = _x((d, B * S, H), seed=22), _x((d, B * S, H), seed=23)
    jm = jrs.MemLSTM(hidden_size=H, bidirectional=bidirectional,
                     mem_type=mem_type)
    tm = trs.MemLSTM(H, bidirectional=bidirectional, mem_type=mem_type,
                     device="cpu")
    hc = (jnp.asarray(h), jnp.asarray(c))
    variables = draw_from_shapes(jax.eval_shape(
        lambda x: jm.init(jax.random.PRNGKey(0), x, S), hc), seed=3)
    if variables:
        load(tm, variables)
    ref = jax.jit(lambda v, x: jm.apply(v, x, S))(_jax(variables), hc)
    with torch.no_grad():
        out = tm.eval()((_t(h), _t(c)), S)
    for a, b in zip(out, ref):
        _rel(a, b, what=mem_type)
    if not bidirectional:  # segment 0 of each item reads a zero memory
        assert float(out[0].reshape(d, B, S, H)[:, :, 0].abs().max()) == 0


RES = dict(encoder_kernel_size=8, encoder_out_nchannels=16,
           masknet_chunksize=6, n_layers=3, nhead=2, d_ffn=32)


@pytest.mark.parametrize("kw", [dict(mem_type="av"),
                                dict(mem_type="hc", seg_model="lstm"),
                                dict(mem_type="h", seg_model="lstm")],
                         ids=["resepformer", "skim", "skim_h"])
def test_resepformer_wrapper_matches_jax(kw):
    cfg = dict(RES, **kw)
    _check(jrs.RESepformerWrapper(**cfg),
           trs.RESepformerWrapper(device="cpu", **cfg), _x((2, 803), seed=24),
           train=False)


@pytest.mark.parametrize("kw", [dict(mem_type="av"),
                                dict(mem_type="hc", seg_model="lstm")],
                         ids=["av", "hc"])
def test_causal_separator_matches_jax(kw):
    cfg = dict(input_dim=8, causal=True, num_spk=2, layer=2, unit=8,
               segment_size=4, nhead=2, d_ffn=16, nonlinear="sigmoid", **kw)
    _check(jrs.ResourceEfficientSeparator(**cfg),
           trs.ResourceEfficientSeparator(device="cpu", **cfg),
           _x((2, 19, 8), seed=25), train=False)


# -- Conv-TasNet -------------------------------------------------------------

TASNET = dict(L=8, N=8, B=4, H=8, P=3, X=2, R=2, num_spks=2)


@pytest.mark.parametrize("kw", [{}, dict(norm_type="cLN", causal=True),
                                dict(mask_nonlinear="softmax")],
                         ids=["gln", "cln_causal", "softmax"])
def test_conv_tasnet_matches_jax(kw):
    cfg = dict(TASNET, **kw)
    _check(jct.ConvTasNetWrapper(**cfg),
           tct.ConvTasNetWrapper(device="cpu", **cfg), _x((2, 403), seed=26),
           train=False)


@pytest.mark.parametrize("mode", ["independent", "cross", "parallel"])
def test_binaural_conv_tasnet_matches_jax(mode):
    cfg = dict(TASNET, X=1, R=1, mode=mode)
    _check(jct.BinauralConvTasNetWrapper(**cfg),
           tct.BinauralConvTasNetWrapper(device="cpu", **cfg),
           _x((2, 1000, 2), seed=27), train=False)


@pytest.mark.parametrize("frames,size", [(63, 999), (9, 7), (250, 40),
                                         (5, 5)],
                         ids=["yaml_ratio_up", "down", "down_6x", "same"])
def test_linear_resize_matches_jax_image_resize(frames, size):
    """(63, 999): the ILD of a 1 s binaural mixture at 8 kHz (n_fft 256,
    hop 128) resized to the encoder's frames (L 16); downsampling
    antialiases as ``jax.image.resize`` does."""
    ild = _x((2, frames, 129), seed=28)
    ref = jax.image.resize(jnp.asarray(ild), (2, size, 129), "linear")
    _rel(tct.linear_resize(_t(ild), size), ref)


def test_cross_mode_ild_matches_jax():
    mix = _x((2, 8000, 2), seed=29)
    jm = jct.BinauralConvTasNetWrapper(mode="cross")
    jild = jm._ild(jnp.asarray(mix))
    tm = tct.BinauralConvTasNetWrapper(L=16, N=8, B=4, H=8, X=1, R=1,
                                       mode="cross", device="cpu")
    _rel(tm._ild(_t(mix)), jild)


# -- SepformerSeparation -----------------------------------------------------

def _interfaces():
    jm = jdp.SepformerWrapper(**SEP)
    tm = tdp.SepformerWrapper(device="cpu", **SEP)
    mix = _x((2, 603), seed=30)
    variables = _pair(jm, tm, mix, train=False)
    p = variables["params"]
    intra = dict(num_layers=1, d_model=16, nhead=2, d_ffn=32)
    jparts = {
        "encoder": jdp.Encoder(kernel_size=8, out_channels=16),
        "masknet": jdp.DualPathModel(
            in_channels=16, out_channels=16,
            intra_model=jdp.SBTransformerBlock(**intra),
            inter_model=jdp.SBTransformerBlock(**intra), num_layers=2, K=8),
        "decoder": jdp.Decoder(kernel_size=8, in_channels=16),
    }
    hp = {"sample_rate": 8000}
    return {
        "mix": mix,
        "jax_whole": JaxSepformerSeparation(
            modules={"masknet": jm}, hparams=hp,
            params={"masknet": _jax(p)}),
        "jax_parts": JaxSepformerSeparation(
            modules=jparts, hparams=hp,
            params={k: _jax(p[k]) for k in jparts}),
        "whole": SepformerSeparation(modules={"masknet": tm}, hparams=hp,
                                     run_opts={"device": "cpu"}),
        "parts": SepformerSeparation(
            modules={"encoder": tm.encoder, "masknet": tm.masknet,
                     "decoder": tm.decoder},
            hparams=hp, run_opts={"device": "cpu"}),
    }


def test_separate_batch_compositions_match_jax(tmp_path):
    sides = _interfaces()
    mix = sides["mix"]
    for name in ("jax_whole", "jax_parts"):  # one program each
        sides[name].separate_batch = jax.jit(sides[name].separate_batch)
    ref = np.asarray(sides["jax_whole"].separate_batch(jnp.asarray(mix)))
    _rel(sides["jax_parts"].separate_batch(jnp.asarray(mix)), ref)
    whole = sides["whole"].separate_batch(_t(mix))
    parts = sides["parts"].separate_batch(_t(mix))
    assert whole.shape == (2, 603, 2)
    _rel(whole, ref)
    assert torch.equal(whole, parts)
    # separate_file: one WAV, each source scaled by its own peak
    path = str(tmp_path / "mix.wav")
    write_audio(path, mix[0], 8000)
    ours = sides["whole"].separate_file(path)
    theirs = sides["jax_whole"].separate_file(path)
    _rel(ours, theirs)
    assert ours.shape == (603, 2)
    np.testing.assert_allclose(ours.abs().amax(0).numpy(), 1.0, rtol=1e-6)
