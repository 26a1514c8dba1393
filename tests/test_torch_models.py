"""The port's models against the JAX package's at a small size:
``ConvolutionFrontEnd``, ``TransformerASR`` (encode, decode, decode_step)
and ``TransformerLM`` (forward, score_step); the containers of
``nnet/containers.py`` and ``TransformerASR.EncoderWrapper``. Weights come from flax's init,
perturbed, through ``utils/jax_bridge``; inputs from numpy.

atol 1e-4: float32 throughout, a few layers deep; the two frameworks sum
in another order."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JaxFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JaxASR,
)
from speechbrain_tpu.lobes.models.transformer.TransformerLM import (
    TransformerLM as JaxLM,
)
from speechbrain_tpu_torch.lobes.models.convolution import ConvolutionFrontEnd
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    TransformerASR,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
    TransformerLM,
)
from speechbrain_tpu_torch.utils.data_utils import pad_time_to_multiple
from speechbrain_tpu_torch.utils.jax_bridge import load

ATOL = 1e-4
V = 24
KEY = jax.random.PRNGKey(0)

ASR_CONFIGS = {
    "conformer_relpos_prenorm": dict(
        tgt_vocab=V, input_size=20, d_model=16, nhead=4,
        num_encoder_layers=2, num_decoder_layers=2, d_ffn=32,
        encoder_module="conformer", attention_type="RelPosMHAXL",
        kernel_size=5, normalize_before=True,
    ),
    "transformer_postnorm": dict(
        tgt_vocab=V, input_size=20, d_model=16, nhead=2,
        num_encoder_layers=1, num_decoder_layers=1, d_ffn=32,
        encoder_module="transformer", attention_type="regularMHA",
        activation="gelu", normalize_before=False,
    ),
}


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(v, seed=1):
    leaves, tree = jax.tree_util.tree_flatten(v)
    rng = np.random.default_rng(seed)
    leaves = [
        leaf + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        for leaf in leaves
    ]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(
        torch_out.detach().numpy(), np.asarray(jax_out), atol=atol
    )


CONV1D_CASES = {
    "same_reflect": dict(kernel_size=3),
    "same_dilated": dict(kernel_size=5, dilation=2),
    "same_strided": dict(kernel_size=3, stride=2),
    "same_zero_padded": dict(kernel_size=5, padding_mode="constant"),
    "causal": dict(kernel_size=4, padding="causal"),
    "valid_depthwise": dict(kernel_size=3, padding="valid", groups=6),
    "no_bias": dict(kernel_size=1, bias=False),
}


@pytest.mark.parametrize("name", sorted(CONV1D_CASES))
def test_conv1d(name):
    from speechbrain_tpu.nnet.CNN import Conv1d as JaxConv1d
    from speechbrain_tpu_torch.nnet.CNN import Conv1d

    kw = CONV1D_CASES[name]
    x = np.random.default_rng(5).standard_normal((2, 11, 6)).astype(
        np.float32
    )
    jconv = JaxConv1d(out_channels=12, **kw)
    v = _perturb(jconv.init(KEY, jnp.asarray(x)))
    conv = load(
        Conv1d(out_channels=12, in_channels=6, device="cpu", **kw),
        _np_tree(v),
    )
    ref = jconv.apply(v, jnp.asarray(x))
    out = conv(_t(x))
    assert out.shape == ref.shape
    _close(out, ref, atol=1e-5)


def test_layernorm_normalises_the_last_axis_only():
    from speechbrain_tpu.nnet.normalization import LayerNorm as JaxLayerNorm
    from speechbrain_tpu_torch.nnet.normalization import LayerNorm

    x = np.random.default_rng(6).standard_normal((2, 5, 4, 3)).astype(
        np.float32
    )
    jln = JaxLayerNorm()
    v = _perturb(jln.init(KEY, jnp.asarray(x)))
    ln = load(LayerNorm(3, device="cpu"), _np_tree(v))
    _close(ln(_t(x)), jln.apply(v, jnp.asarray(x)), atol=1e-5)


def test_convolution_frontend():
    x = np.random.default_rng(0).standard_normal((2, 51, 20)).astype(
        np.float32
    )
    kw = dict(num_blocks=2, out_channels=(8, 4), kernel_sizes=(3, 3),
              strides=(2, 2))
    jfe = JaxFrontEnd(**kw)
    v = _perturb(jfe.init(KEY, jnp.asarray(x), train=False))
    fe = load(ConvolutionFrontEnd(**kw, device="cpu").eval(), _np_tree(v))
    ref = jfe.apply(v, jnp.asarray(x), train=False)
    out = fe(_t(x))
    # reflect 'same' padding with stride 2: 51 -> 26 -> 13 frames
    assert out.shape == ref.shape == (2, 13, 20)
    _close(out, ref)


def test_convolution_frontend_length_at_full_width():
    """1001 frames of 80 mels come out as 251 frames of 640 features, as
    in the JAX package (shape only, no weights)."""
    fe = ConvolutionFrontEnd(
        num_blocks=2, out_channels=(4, 2), kernel_sizes=(3, 3),
        strides=(2, 2), device="cpu",
    ).eval()
    out = fe(torch.zeros(1, 1001, 80))
    assert out.shape == (1, 251, 40)
    padded, lens = pad_time_to_multiple(out, torch.ones(1), multiple=128)
    assert padded.shape == (1, 256, 40)
    assert float(lens[0]) == 251 / 256


@pytest.fixture(scope="module", params=sorted(ASR_CONFIGS))
def asr(request):
    cfg = ASR_CONFIGS[request.param]
    rng = np.random.default_rng(2)
    src = rng.standard_normal((2, 12, 20)).astype(np.float32)
    tok = rng.integers(0, V, (2, 5)).astype(np.int32)
    lens = np.array([1.0, 0.7], np.float32)
    jnet = JaxASR(**cfg)
    v = _perturb(jnet.init(KEY, jnp.asarray(src), jnp.asarray(tok)))
    net = load(TransformerASR(**cfg, device="cpu").eval(), _np_tree(v))
    return jnet, v, net, src, tok, lens


def test_asr_encode(asr):
    jnet, v, net, src, _, lens = asr
    ref = jnet.apply(v, jnp.asarray(src), jnp.asarray(lens), method="encode")
    with torch.no_grad():
        out = net.encode(_t(src), _t(lens))
    _close(out, ref)


def test_asr_forward_and_decode(asr):
    jnet, v, net, src, tok, lens = asr
    ref_enc, ref_dec = jnet.apply(
        v, jnp.asarray(src), jnp.asarray(tok), jnp.asarray(lens)
    )
    with torch.no_grad():
        enc, dec = net(_t(src), _t(tok), _t(lens))
        out, attn = net.decode(_t(tok), enc, _t(lens))
    _close(enc, ref_enc)
    _close(dec, ref_dec)
    ref_out, ref_attn = jnet.apply(
        v, jnp.asarray(tok), ref_enc, jnp.asarray(lens), method="decode"
    )
    _close(out, ref_out)
    _close(attn, ref_attn)


@pytest.mark.parametrize("shared_cross", [False, True])
def test_asr_decode_step_matches_jax_and_full_decode(asr, shared_cross):
    """Feed a forced token sequence one step at a time through the KV
    cache (cross K/V precomputed or projected each step); every step's
    output equals JAX's, and equals the full-buffer decode at that
    position."""
    jnet, v, net, src, tok, lens = asr
    jenc = jnet.apply(v, jnp.asarray(src), jnp.asarray(lens), method="encode")
    with torch.no_grad():
        enc = net.encode(_t(src), _t(lens))
        full, _ = net.decode(_t(tok), enc, _t(lens))
        if shared_cross:
            jcache = jnet.apply(
                v, jenc, 5, method="init_decoder_cache_with_cross"
            )
            cache = net.init_decoder_cache_with_cross(enc, 5)
        else:
            jcache = jnet.apply(v, 2, 5, method="init_decoder_cache")
            cache = net.init_decoder_cache(2, 5)
        # length rounded up to a multiple of 32
        assert cache[0]["self"]["k"].shape == (2, 32, 16)
        assert jcache[0]["self"]["k"].shape == (2, 32, 16)
        for step in range(tok.shape[1]):
            ref, jcache, ref_attn = jnet.apply(
                v, jnp.asarray(tok[:, step]), jenc, jcache, step,
                jnp.asarray(lens), method="decode_step",
            )
            out, cache, attn = net.decode_step(
                _t(tok[:, step]), enc, cache, step, _t(lens)
            )
            _close(out, ref)
            _close(attn, ref_attn)
            _close(out, full[:, step])


@pytest.fixture(scope="module")
def lm():
    kw = dict(vocab=V, d_model=16, nhead=4, num_encoder_layers=2, d_ffn=32,
              dropout=0.0, activation="gelu", normalize_before=False)
    tok = np.random.default_rng(3).integers(0, V, (3, 6)).astype(np.int32)
    jlm = JaxLM(**kw)
    v = _perturb(jlm.init(KEY, jnp.asarray(tok)))
    tlm = load(TransformerLM(**kw, device="cpu").eval(), _np_tree(v))
    return jlm, v, tlm, tok


def test_lm_forward(lm):
    jlm, v, tlm, tok = lm
    with torch.no_grad():
        _close(tlm(_t(tok)), jlm.apply(v, jnp.asarray(tok)))


def test_lm_score_step(lm):
    jlm, v, tlm, tok = lm
    jcache = jlm.apply(v, 3, 6, method="init_cache")
    with torch.no_grad():
        full = tlm(_t(tok))
        cache = tlm.init_cache(3, 6)
        for step in range(tok.shape[1]):
            ref, jcache = jlm.apply(
                v, jnp.asarray(tok[:, step]), jcache, step,
                method="score_step",
            )
            out, cache = tlm.score_step(_t(tok[:, step]), cache, step)
            _close(out, ref)
            _close(out, full[:, step])


def test_lm_with_embedding_projection():
    kw = dict(vocab=V, d_model=16, nhead=2, num_encoder_layers=1, d_ffn=32,
              d_embedding=8, normalize_before=True)
    tok = np.random.default_rng(4).integers(0, V, (2, 4)).astype(np.int32)
    jlm = JaxLM(**kw)
    v = _perturb(jlm.init(KEY, jnp.asarray(tok)))
    tlm = load(TransformerLM(**kw, device="cpu").eval(), _np_tree(v))
    with torch.no_grad():
        _close(tlm(_t(tok)), jlm.apply(v, jnp.asarray(tok)))


def test_bridge_refuses_a_wrong_tree(lm):
    _, v, _, _ = lm
    tree = _np_tree(v)["params"]
    fresh = TransformerLM(vocab=V, d_model=16, nhead=4, num_encoder_layers=3,
                          d_ffn=32, device="cpu")
    with pytest.raises(KeyError, match="layer_2"):
        load(fresh, tree)
    with pytest.raises(TypeError, match="no loader"):
        load(torch.nn.ReLU(), tree)


def test_initialisation_follows_the_generator():
    def build(seed):
        return TransformerLM(
            vocab=V, d_model=16, nhead=4, num_encoder_layers=1, d_ffn=32,
            device="cpu", generator=torch.Generator().manual_seed(seed),
        )

    a, b, c = build(0), build(0), build(1)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.out.weight, c.out.weight)
    # N(0, 1/fan_in) for Linear kernels
    w = TransformerLM(
        vocab=2000, d_model=64, nhead=4, num_encoder_layers=1, d_ffn=64,
        device="cpu", generator=torch.Generator().manual_seed(0),
    ).out.weight
    assert abs(float(w.detach().std()) - 64 ** -0.5) < 0.01


# -- containers and EncoderWrapper (nnet/containers.py) ----------------------

def _jax_linear(n):
    from speechbrain_tpu.nnet.linear import Linear as JaxLinear

    return JaxLinear(n_neurons=n)


def _port_linear(n, d):
    from speechbrain_tpu_torch.nnet.linear import Linear

    return Linear(n, d, device="cpu")


def _container_case(name):
    """(JAX container, port container, port modules by the flax scope that
    holds their weights, whether it takes lengths)."""
    from speechbrain_tpu.nnet import containers as jc
    from speechbrain_tpu_torch.nnet import containers as tc

    if name == "sequential":
        a, b = _port_linear(16, 8), _port_linear(4, 16)
        return (jc.Sequential(layers=(_jax_linear(16), jnp.tanh,
                                      _jax_linear(4))),
                tc.Sequential([a, torch.tanh, b]),
                {"layers_0": a, "layers_2": b}, False)
    if name == "module_list":
        a, b = _port_linear(8, 8), _port_linear(8, 8)
        return (jc.ModuleList(layers=(_jax_linear(8), _jax_linear(8))),
                tc.ModuleList([a, b]), {"layers_0": a, "layers_1": b}, False)
    if name.startswith("connect"):
        kind = name.split("_", 1)[1]
        shortcut, combine = {"residual": ("residual", "add"),
                             "avg": ("residual", "avg"),
                             "skip": ("skip", "add")}[kind]
        a, b = _port_linear(8, 8), _port_linear(6, 8)
        port = tc.ConnectBlocks([a, b], shortcut_type=shortcut,
                                shortcut_projection=shortcut != "skip",
                                combine_fn=combine, device="cpu")
        scopes = {"blocks_0": a, "blocks_1": b}
        if shortcut != "skip":
            port(torch.zeros(1, 1, 8))  # makes the projection
            scopes["proj_1"] = port.projections["proj_1"]
        return (jc.ConnectBlocks(blocks=(_jax_linear(8), _jax_linear(6)),
                                 shortcut_type=shortcut,
                                 shortcut_projection=shortcut != "skip",
                                 combine_fn=combine),
                port, scopes, False)
    # lengths: a Linear, the encoder alone, a Linear
    cfg = dict(ASR_CONFIGS["conformer_relpos_prenorm"], input_size=8,
               num_decoder_layers=0, num_encoder_layers=1)
    net = TransformerASR(**cfg, device="cpu").eval()
    a, b = _port_linear(8, 8), _port_linear(4, 16)
    from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
        EncoderWrapper as JaxEncoderWrapper,
    )
    from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
        EncoderWrapper,
    )

    jax_net = JaxASR(**cfg)
    return (jc.LengthsCapableSequential(layers=(
                _jax_linear(8), JaxEncoderWrapper(transformer=jax_net),
                _jax_linear(4))),
            tc.LengthsCapableSequential([a, EncoderWrapper(net), b]),
            {"layers_0": a, "layers_1/transformer": net, "layers_2": b},
            True)


CONTAINER_CASES = ["sequential", "module_list", "connect_residual",
                   "connect_avg", "connect_skip", "lengths_encoder"]


@pytest.mark.parametrize("name", CONTAINER_CASES)
def test_containers_match_jax(name):
    """The same weights (flax's init, perturbed) in each container of both
    packages; the lengths case ends in ``EncoderWrapper`` with an
    utterance at 0.6 of the padded length."""
    jax_mod, port, scopes, takes_lengths = _container_case(name)
    x = np.random.default_rng(3).standard_normal((2, 10, 8)).astype(
        np.float32)
    lens = np.array([1.0, 0.6], np.float32)
    kwargs = {"lengths": jnp.asarray(lens)} if takes_lengths else {}
    v = _perturb(jax_mod.init(KEY, jnp.asarray(x), **kwargs))
    ref = jax_mod.apply(v, jnp.asarray(x), **kwargs)
    params = _np_tree(v)["params"]
    for path, module in scopes.items():
        tree = params
        for key in path.split("/"):
            tree = tree[key]
        load(module, tree)
    port.eval()
    with torch.no_grad():
        out = port(_t(x), lengths=_t(lens)) if takes_lengths else port(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_lengths_capable_sequential_carries_new_lengths():
    """A layer that pads the time axis hands its rescaled lengths to the
    layers after it and to the caller; a chain without one returns the
    output alone."""
    from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
        EncoderWrapper,
    )
    from speechbrain_tpu_torch.nnet.containers import (
        LengthsCapableSequential,
    )

    cfg = dict(ASR_CONFIGS["conformer_relpos_prenorm"], input_size=8,
               num_decoder_layers=0, num_encoder_layers=1)
    net = TransformerASR(**cfg, device="cpu").eval()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 10, 8)).astype(np.float32))
    lens = torch.tensor([1.0, 0.6])
    chain = LengthsCapableSequential([
        functools.partial(pad_time_to_multiple, multiple=8),
        EncoderWrapper(net)])
    with torch.no_grad():
        out, out_lens = chain(x, lengths=lens)
        padded, lens_p = pad_time_to_multiple(x, lens, multiple=8)
        ref = net.encode(padded, wav_len=lens_p)
        plain = LengthsCapableSequential([EncoderWrapper(net)])(x, lens)
    assert out.shape[1] == 16 and torch.equal(out_lens, lens_p)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert isinstance(plain, torch.Tensor)
    assert set(dict(chain.named_parameters())) == {
        "1." + k for k, _ in EncoderWrapper(net).named_parameters()}
