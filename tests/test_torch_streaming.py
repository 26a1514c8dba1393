"""Streaming ASR on the port against the JAX package at a small size (d 16,
2 Conformer layers, kernel 5, chunk 4, left context 2): the dynamic chunk
sampler's draws, the chunked masks, the chunked convolution module and
``encode`` under a chunk configuration, ``encode_streaming``,
``StreamingFeatureWrapper``, the filter properties and streaming helpers,
``StreamingASR`` over the fake stack of
``tests/unittests/test_streaming_sources.py``, ``pcm_stream`` and
``ffmpeg_audio_stream``, and a tiny streaming transducer end to end.

Three faults of the JAX streaming path are shown beside the port's
agreement with the offline computation (ROADMAP.md C34-C36): JAX's
``encode_streaming`` departs from its own chunked ``encode`` once the
convolution modules' LayerNorm and ``pw1`` biases are not zero, and, for
an encoder with the absolute position encoding, after the first chunk;
JAX's ``StreamingFeatureWrapper`` yields one frame more a chunk than the
offline ``Fbank``, repeating a frame at every chunk's start.

Weights are drawn with numpy into the shapes of flax's variables and
carried into the port through ``utils/jax_bridge``. Tolerances: the
convolution module, ``encode`` and the streamed states 1e-5 absolute
(float32, sums in another order); the streamed features equal the port's
offline features bit for bit, and JAX's within 5e-3 dB; tokens and texts
equal; the JAX departures more than 1e-2."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.core import Stage as JaxStage
from speechbrain_tpu.decoders.transducer import (
    TransducerGreedySearcherStreamingContext as JaxGreedyContext,
)
from speechbrain_tpu.inference import streaming as jax_streaming
from speechbrain_tpu.lobes.features import Fbank as JaxFbank
from speechbrain_tpu.lobes.features import (
    StreamingFeatureWrapper as JaxWrapper,
)
from speechbrain_tpu.lobes.features import upalign_value as jax_upalign
from speechbrain_tpu.lobes.models.transformer.Conformer import (
    ConvolutionModule as JaxConvolutionModule,
)
from speechbrain_tpu.lobes.models.transformer.Conformer import (
    make_chunked_attention_mask as jax_chunked_mask,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JaxASR,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    make_transformer_src_mask as jax_src_mask,
)
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.utils import streaming as jax_utils
from speechbrain_tpu.utils.dynamic_chunk_training import (
    DynChunkTrainConfig as JaxConfig,
)
from speechbrain_tpu.utils.dynamic_chunk_training import (
    DynChunkTrainConfigRandomSampler as JaxSampler,
)
from speechbrain_tpu.utils.filter_analysis import (
    FilterProperties as JaxFilterProperties,
)
from speechbrain_tpu.utils.filter_analysis import (
    stack_filter_properties as jax_stack,
)
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.dataio.dataio import write_audio
from speechbrain_tpu_torch.decoders.transducer import (
    TransducerGreedySearcherStreamingContext,
)
from speechbrain_tpu_torch.inference import streaming
from speechbrain_tpu_torch.lobes.features import (
    Fbank,
    StreamingFeatureWrapper,
    upalign_value,
)
from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
    ConvolutionModule,
    make_chunked_attention_mask,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    EncoderWrapper,
    TransformerASR,
    make_transformer_src_mask,
)
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.utils import streaming as utils
from speechbrain_tpu_torch.utils.dynamic_chunk_training import (
    DynChunkTrainConfig,
    DynChunkTrainConfigRandomSampler,
)
from speechbrain_tpu_torch.utils.filter_analysis import (
    FilterProperties,
    stack_filter_properties,
)
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_families import _np_tree, _params, _t
from test_torch_transducer import J_ENC, Nets

ATOL = 1e-5
# dB: the features' tolerance against JAX's of test_torch_mel_frontend.py
# (the JAX Fbank transforms by a matmul, the port's by an FFT)
FEATURE_ATOL = 5e-3
DEPARTURE = 1e-2
D, LAYERS, KERNEL, CHUNK, LEFT, FRAMES, F_IN = 16, 2, 5, 4, 2, 16, 12
CONFIG = DynChunkTrainConfig(CHUNK, LEFT)
JCONFIG = JaxConfig(CHUNK, LEFT)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol)


# -- the configuration and its sampler -------------------------------------

@pytest.mark.parametrize("stage", ["TRAIN", "VALID", "TEST"])
def test_sampler_draws_match_jax(stage):
    kw = dict(seed=3)
    ours = DynChunkTrainConfigRandomSampler(
        valid_config=DynChunkTrainConfig(24, 4),
        test_config=DynChunkTrainConfig(16, None), **kw)
    ref = JaxSampler(valid_config=JaxConfig(24, 4),
                     test_config=JaxConfig(16, None), **kw)
    got = [ours(getattr(Stage, stage)) for _ in range(50)]
    want = [ref(getattr(JaxStage, stage)) for _ in range(50)]

    def fields(c):
        return None if c is None else (c.chunk_size, c.left_context_size)

    assert [fields(c) for c in got] == [fields(c) for c in want]
    if stage == "TRAIN":
        # chunked with and without a left context, and full context
        kinds = {None if c is None else c.left_context_size is None
                 for c in got}
        assert kinds == {None, True, False}
        for c in got:
            if c is not None:
                assert c.left_context_size_frames() == (
                    None if c.is_infinite_left_context()
                    else c.chunk_size * c.left_context_size)


@pytest.mark.parametrize("T, chunk, left", [(16, 4, 2), (10, 3, None),
                                            (7, 8, 0), (9, 2, 1)])
def test_chunked_masks_match_jax(T, chunk, left):
    np.testing.assert_array_equal(
        make_chunked_attention_mask(T, chunk, left, device="cpu").numpy(),
        jax_chunked_mask(T, chunk, left))
    src = torch.zeros(2, T, 3)
    got = make_transformer_src_mask(src, DynChunkTrainConfig(chunk, left))
    want = jax_src_mask(jnp.zeros((2, T, 3)), JaxConfig(chunk, left))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert make_transformer_src_mask(src, None) is None


# -- the chunked convolution module and encode -----------------------------

@pytest.mark.parametrize("T, chunk", [(16, 4), (13, 4), (11, 8), (9, 1)])
def test_chunked_convolution_module_matches_jax(T, chunk):
    x = _x((2, T, D), seed=T)
    jm = JaxConvolutionModule(input_size=D, kernel_size=KERNEL)
    v = _params(jm, x, dynchunktrain_config=JaxConfig(chunk))
    ref = jm.apply(v, x, dynchunktrain_config=JaxConfig(chunk))
    m = load(ConvolutionModule(D, kernel_size=KERNEL, device="cpu").eval(),
             _np_tree(v))
    with torch.no_grad():
        out = m(_t(x), dynchunktrain_config=DynChunkTrainConfig(chunk))
        full = m(_t(x))
    _close(out, ref)
    # the chunks change the output: no frame sees a later chunk
    assert (out - full).abs().max() > DEPARTURE


def _asr_kw(decoder_layers=0, attention_type="RelPosMHAXL"):
    return dict(tgt_vocab=8, input_size=F_IN, d_model=D, nhead=4,
                num_encoder_layers=LAYERS, num_decoder_layers=decoder_layers,
                d_ffn=32, encoder_module="conformer",
                attention_type=attention_type, kernel_size=KERNEL,
                dropout=0.0)


def _asr(decoder_layers=0, conv_biases=True, seed=1,
         attention_type="RelPosMHAXL"):
    """A JAX and a port ``TransformerASR`` with the same weights (biases
    about 0.1; with ``conv_biases`` False the convolution modules'
    LayerNorm and ``pw1`` biases are zero)."""
    kw = _asr_kw(decoder_layers, attention_type)
    src = jnp.asarray(_x((2, FRAMES, F_IN), seed=5))
    tok = jnp.ones((2, 3), jnp.int32)
    jnet = JaxASR(**kw)
    v = _params(jnet, src, tok, seed=seed)
    tree = jax.tree_util.tree_map(np.array, _np_tree(v))
    if not conv_biases:
        for layer in tree["params"]["encoder"].values():
            if "conv" in layer:
                layer["conv"]["layer_norm"]["LayerNorm_0"]["bias"][:] = 0.0
                layer["conv"]["pw1"]["bias"][:] = 0.0
        v = jax.tree_util.tree_map(jnp.asarray, tree)
    net = load(TransformerASR(**kw, device="cpu").eval(), tree)
    return jnet, v, net


def test_encode_and_forward_under_a_chunk_config_match_jax():
    jnet, v, net = _asr(decoder_layers=1)
    src = _x((2, FRAMES, F_IN), seed=6)
    tok = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32)
    lens = np.asarray([1.0, 0.75], np.float32)
    jenc = jnet.apply(v, jnp.asarray(src), jnp.asarray(lens),
                      dynchunktrain_config=JCONFIG, method="encode")
    jfwd, jdec = jnet.apply(v, jnp.asarray(src), jnp.asarray(tok),
                            jnp.asarray(lens), dynchunktrain_config=JCONFIG)
    with torch.no_grad():
        enc = net.encode(_t(src), _t(lens), dynchunktrain_config=CONFIG)
        fwd, dec = net(_t(src), _t(tok), _t(lens),
                       dynchunktrain_config=CONFIG)
        wrapped = EncoderWrapper(net)(_t(src), _t(lens),
                                      dynchunktrain_config=CONFIG)
        full = net.encode(_t(src), _t(lens))
    _close(enc, jenc)
    _close(fwd, jfwd)
    _close(dec, jdec)
    assert torch.equal(wrapped, enc)
    assert (enc - full).abs().max() > DEPARTURE


def _jax_stream(jnet, v, src, config, batch=2):
    ctx = jnet.make_streaming_context(batch, config)
    outs = []
    for i in range(0, src.shape[1], CHUNK):
        out, ctx = jnet.apply(v, jnp.asarray(src[:, i:i + CHUNK]), ctx,
                              method="encode_streaming")
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=1)


def _stream(net, src, config, batch=2):
    ctx = net.make_streaming_context(batch, config)
    outs = []
    with torch.no_grad():
        for i in range(0, src.shape[1], config.chunk_size):
            out, ctx = net.encode_streaming(
                _t(src[:, i:i + config.chunk_size]), ctx)
            outs.append(out)
    return torch.cat(outs, dim=1)


def test_encode_streaming_matches_jax_where_its_conv_biases_are_zero():
    jnet, v, net = _asr(conv_biases=False)
    src = _x((2, FRAMES, F_IN), seed=7)
    _close(_stream(net, src, CONFIG), _jax_stream(jnet, v, src, JCONFIG))


def test_encode_streaming_equals_the_chunked_encode_c34():
    """With the convolution modules' LayerNorm and ``pw1`` biases not
    zero, the port's streamed states equal JAX's chunked offline encode
    (and the port's), while JAX's ``encode_streaming`` departs from it
    (ROADMAP.md C34)."""
    jnet, v, net = _asr()
    src = _x((2, FRAMES, F_IN), seed=8)
    offline = np.asarray(jnet.apply(v, jnp.asarray(src),
                                    dynchunktrain_config=JCONFIG,
                                    method="encode"))
    ours = _stream(net, src, CONFIG)
    _close(ours, offline)
    with torch.no_grad():
        _close(ours, net.encode(_t(src), dynchunktrain_config=CONFIG))
    jax_streamed = _jax_stream(jnet, v, src, JCONFIG)
    departure = np.abs(jax_streamed - offline).max(axis=(0, 2))
    assert departure.max() > DEPARTURE
    # the zeros enter at the stream's start
    assert departure[0] > DEPARTURE


def test_encode_streaming_keeps_absolute_positions_c36():
    """An encoder with the absolute sine encoding (``regularMHA``, the
    transducer recipes' default), the convolution biases zero: the port's
    streamed states equal JAX's chunked offline encode, while JAX's
    ``encode_streaming``, which restarts the positions at every chunk,
    departs from it after the first chunk (ROADMAP.md C36)."""
    jnet, v, net = _asr(conv_biases=False, attention_type="regularMHA")
    src = _x((2, FRAMES, F_IN), seed=15)
    offline = np.asarray(jnet.apply(v, jnp.asarray(src),
                                    dynchunktrain_config=JCONFIG,
                                    method="encode"))
    _close(_stream(net, src, CONFIG), offline)
    departure = np.abs(_jax_stream(jnet, v, src, JCONFIG)
                       - offline).max(axis=(0, 2))
    assert departure[:CHUNK].max() <= ATOL
    assert departure[CHUNK:].max() > DEPARTURE


def test_a_stream_ends_at_max_length():
    net = TransformerASR(**{**_asr_kw(attention_type="regularMHA"),
                            "max_length": 2 * CHUNK}, device="cpu").eval()
    ctx = net.make_streaming_context(1, CONFIG)
    with torch.no_grad():
        for _ in range(2):
            net.encode_streaming(torch.zeros(1, CHUNK, F_IN), ctx)
        with pytest.raises(ValueError, match="max_len"):
            net.encode_streaming(torch.zeros(1, CHUNK, F_IN), ctx)


def test_encode_streaming_with_an_unlimited_left_context():
    _, _, net = _asr()
    src = _x((2, FRAMES, F_IN), seed=9)
    config = DynChunkTrainConfig(CHUNK, None)
    with torch.no_grad():
        offline = net.encode(_t(src), dynchunktrain_config=config)
    _close(_stream(net, src, config), offline.numpy())


# -- features --------------------------------------------------------------

def test_filter_properties_and_upalign_match_jax():
    fb, jfb = Fbank(n_mels=80, device="cpu"), JaxFbank(n_mels=80)
    assert fb.get_filter_properties() == FilterProperties(
        **vars(jfb.get_filter_properties()))
    got = stack_filter_properties([fb, FilterProperties(3, 2),
                                   FilterProperties(3, 2, dilation=2)])
    want = jax_stack([jfb, JaxFilterProperties(3, 2),
                      JaxFilterProperties(3, 2, dilation=2)])
    assert vars(got) == vars(want)
    causal = FilterProperties(5, causal=True)
    assert causal.get_convolution_padding() == JaxFilterProperties(
        5, causal=True).get_convolution_padding()
    assert vars(causal.get_noncausal_equivalent()) == vars(
        JaxFilterProperties(5, causal=True).get_noncausal_equivalent())
    assert [upalign_value(x, 160) for x in (0, 1, 199, 320)] == [
        jax_upalign(x, 160) for x in (0, 1, 199, 320)]
    wrapper = StreamingFeatureWrapper(fb)
    jwrapper = JaxWrapper(jfb)
    for name in ("get_required_padding", "get_output_count_per_pad_frame"):
        assert getattr(wrapper, name)() == getattr(jwrapper, name)()
    assert wrapper.get_recommended_final_chunk_count(96) == \
        jwrapper.get_recommended_final_chunk_count(96)


# chunk 24 of StreamingASR.get_chunk_size_frames at front-end stride 4
WRAPPER_CHUNK = 24 * 160 * 4
WRAPPER_CHUNKS = 4


def _wrapped(wrapper, wav):
    ctx = wrapper.make_streaming_context(wav.shape[0])
    out = []
    for c in range(WRAPPER_CHUNKS):
        chunk = wav[:, c * WRAPPER_CHUNK:(c + 1) * WRAPPER_CHUNK]
        feats, ctx = wrapper(chunk, ctx)
        out.append(feats)
    return out, ctx


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_the_wrapper_yields_the_offline_frames_c35(fused):
    """Over four 15,360-sample chunks the port's wrapper yields 96 frames
    a chunk: two frames before the stream, then the offline ``Fbank``'s
    frames once and in order, bit for bit (and JAX's offline frames
    within 5e-3 dB); JAX's wrapper yields 97 a chunk, each chunk after
    the first repeating the previous chunk's last frame (ROADMAP.md
    C35)."""
    wav = 0.3 * _x((2, WRAPPER_CHUNK * WRAPPER_CHUNKS), seed=11)
    fbank = Fbank(n_mels=80, fused=fused, device="cpu")
    offline = fbank(_t(wav))
    joffline = np.asarray(JaxFbank(n_mels=80)(jnp.asarray(wav)))
    wrapper = StreamingFeatureWrapper(fbank)
    ours, ctx = _wrapped(wrapper, _t(wav))
    lag = wrapper.get_output_count_per_pad_frame()
    assert lag == 2
    assert [f.shape[1] for f in ours] == [96] * WRAPPER_CHUNKS
    stream = torch.cat(ours, dim=1)
    n = stream.shape[1] - lag
    assert torch.equal(stream[:, lag:], offline[:, :n])
    if not fused:
        _close(stream[:, lag:], joffline[:, :n], atol=FEATURE_ATOL)
    # a chunk of zeros after the stream brings the offline frames' tail
    tail, _ = wrapper(torch.zeros(2, WRAPPER_CHUNK), ctx)
    assert torch.equal(tail[:, :lag + 1], offline[:, n:])
    # JAX's wrapper: 97 frames a chunk, 388 where the offline has 385
    theirs, _ = _wrapped(JaxWrapper(JaxFbank(n_mels=80)), jnp.asarray(wav))
    theirs = [np.asarray(f) for f in theirs]
    assert [f.shape[1] for f in theirs] == [97] * WRAPPER_CHUNKS
    assert offline.shape[1] == 385
    for c in range(1, WRAPPER_CHUNKS):
        np.testing.assert_array_equal(theirs[c][:, 0], theirs[c - 1][:, -1])
    stream = np.concatenate(theirs, axis=1)
    assert np.abs(stream[:, lag:lag + n] - joffline[:, :n]).max() > 1.0


def test_the_wrapper_refuses_a_partial_stride():
    wrapper = StreamingFeatureWrapper(Fbank(device="cpu"))
    with pytest.raises(ValueError, match="stride"):
        wrapper(torch.zeros(1, 1000), wrapper.make_streaming_context())


# -- streaming helpers -----------------------------------------------------

def test_streaming_helpers_match_jax():
    x = _x((2, 100))
    got = utils.split_fixed_chunks(torch.from_numpy(x), 30)
    want = jax_utils.split_fixed_chunks(x, 30)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    lens = np.asarray([1.0, 0.5, 0.2], np.float32)
    for a, b in zip(utils.split_wav_lens([30, 30, 10], lens),
                    jax_utils.split_wav_lens([30, 30, 10], lens)):
        np.testing.assert_array_equal(a, b)
    mask = [0, 1, 1, 0, 1, 0, 0, 1, 1, 1]
    assert utils.boolean_mask_to_chunks(mask) == \
        jax_utils.boolean_mask_to_chunks(mask)


# -- StreamingASR ----------------------------------------------------------

class _FakeTokenizer:
    def decode_ids(self, ids):
        return "".join(chr(ord("a") + (i % 26)) for i in ids)


def _fake_hparams():
    """The fake stack of ``tests/unittests/test_streaming_sources.py``:
    the 'encoder' counts samples, so that any chunking mismatch changes
    the text."""

    def make_ctx(batch, cfg):
        return {"count": 0}

    def encode_chunk(feats, ctx):
        start = ctx["count"]
        return (start, np.asarray(feats)), {"count": start + feats.shape[1]}

    def decode_chunk(enc, ctx):
        start, feats = enc
        val = int(start // feats.shape[1] + int(abs(feats).sum()) % 7)
        return [[val]], ctx

    return {"sample_rate": 16000, "make_streaming_context": make_ctx,
            "encode_chunk": encode_chunk, "decode_chunk": decode_chunk,
            "tokenizer": _FakeTokenizer(), "samples_per_frame": 160}


def test_streaming_asr_matches_jax_on_the_fake_stack(tmp_path):
    audio = 0.1 * _x((16000 * 3,), seed=12)
    path = tmp_path / "long.wav"
    write_audio(str(path), audio, 16000)
    cfg, jcfg = DynChunkTrainConfig(8, 2), JaxConfig(8, 2)
    asr = streaming.StreamingASR(hparams=_fake_hparams(),
                                 run_opts={"device": "cpu"})
    jasr = jax_streaming.StreamingASR(hparams=_fake_hparams())
    assert asr.get_chunk_size_frames(cfg) == jasr.get_chunk_size_frames(jcfg)
    full = list(asr.transcribe_file_streaming(str(path), cfg))
    assert full == list(jasr.transcribe_file_streaming(str(path), jcfg))
    assert asr.transcribe_file(str(path), cfg) == jasr.transcribe_file(
        str(path), jcfg)
    assert asr.transcribe_file(str(path)) == jasr.transcribe_file(str(path))
    # a live source: raw PCM read in awkward sizes, re-chunked
    streamed = list(asr.transcribe_stream(
        streaming.pcm_stream(io.BytesIO(audio.tobytes()), 777), cfg))
    jstreamed = list(jasr.transcribe_stream(
        jax_streaming.pcm_stream(io.BytesIO(audio.tobytes()), 777), jcfg))
    assert streamed == jstreamed


def test_streaming_asr_needs_its_hparams():
    with pytest.raises(ValueError, match="encode_chunk"):
        streaming.StreamingASR(hparams={"sample_rate": 16000,
                                        "make_streaming_context": None},
                               run_opts={"device": "cpu"})


def test_pcm_stream_matches_jax():
    sig = np.arange(10, dtype=np.float32)
    out = list(streaming.pcm_stream(io.BytesIO(sig.tobytes()), 4))
    ref = list(jax_streaming.pcm_stream(io.BytesIO(sig.tobytes()), 4))
    assert [len(c) for c in out] == [len(c) for c in ref] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(out), sig)
    # a trailing partial sample is dropped, as JAX drops it
    raw = sig[:3].tobytes() + b"\x01\x02"
    assert [c.tolist() for c in streaming.pcm_stream(io.BytesIO(raw), 4)] \
        == [c.tolist() for c in jax_streaming.pcm_stream(io.BytesIO(raw), 4)]


def test_ffmpeg_stream_raises_without_the_binary(monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        list(streaming.ffmpeg_audio_stream("rtmp://x", 100))


# -- a tiny streaming transducer end to end --------------------------------

def _transducer(conv_biases):
    """``_asr``'s encoder, an ``enc_proj`` to the joint's width and
    ``test_torch_transducer.Nets``' prediction network, joint and head, on
    both sides."""
    jnet, v, net = _asr(conv_biases=conv_biases, seed=4)
    jproj = JaxLinear(n_neurons=J_ENC)
    pv = _params(jproj, jnp.zeros((2, 1, D)), seed=5)
    proj = load(Linear(J_ENC, D, device="cpu"), _np_tree(pv))
    return jnet, v, net, jproj, pv, proj, Nets(seed=40, blank_bias=0.2)


def test_streaming_greedy_matches_jax_chunk_by_chunk():
    """Where JAX's streaming encoder is right (zero convolution biases),
    its chunk loop and the port's give the same states and tokens at
    every chunk."""
    jnet, v, net, jproj, pv, proj, nets = _transducer(conv_biases=False)
    src = _x((2, FRAMES, F_IN), seed=13)
    jsearch = nets.jax_searcher(beam_size=1, max_symbols_per_step=3)
    search = nets.searcher(beam_size=1, max_symbols_per_step=3)
    jctx, ctx = jnet.make_streaming_context(2, JCONFIG), \
        net.make_streaming_context(2, CONFIG)
    jdec, dec = JaxGreedyContext(), TransducerGreedySearcherStreamingContext()
    emitted = 0
    with torch.no_grad():
        for i in range(0, FRAMES, CHUNK):
            jout, jctx = jnet.apply(v, jnp.asarray(src[:, i:i + CHUNK]), jctx,
                                    method="encode_streaming")
            jenc = jproj.apply(pv, jout)
            out, ctx = net.encode_streaming(_t(src[:, i:i + CHUNK]), ctx)
            enc = proj(out)
            _close(enc, jenc)
            want = jsearch.transducer_greedy_decode_streaming(jenc, jdec)
            got = search.transducer_greedy_decode_streaming(enc, dec)
            assert got == want
            emitted += sum(len(h) for h in got)
    assert emitted > 0


def test_a_streaming_transducer_end_to_end():
    """With non-zero biases: the streamed states equal the chunked offline
    encode, and the streaming greedy's tokens equal greedy over the
    concatenated streamed states."""
    _, _, net, _, _, proj, nets = _transducer(conv_biases=True)
    src = _x((2, FRAMES, F_IN), seed=14)
    search = nets.searcher(beam_size=1, max_symbols_per_step=3)
    ctx = net.make_streaming_context(2, CONFIG)
    dec = TransducerGreedySearcherStreamingContext()
    tokens, states = [[], []], []
    with torch.no_grad():
        for i in range(0, FRAMES, CHUNK):
            out, ctx = net.encode_streaming(_t(src[:, i:i + CHUNK]), ctx)
            states.append(proj(out))
            for row, new in zip(tokens, search.transducer_greedy_decode_streaming(
                    states[-1], dec)):
                row.extend(new)
        offline = proj(net.encode(_t(src), dynchunktrain_config=CONFIG))
    streamed = torch.cat(states, dim=1)
    _close(streamed, offline.numpy())
    whole, *_ = nets.searcher(beam_size=1, max_symbols_per_step=3)(streamed)
    assert tokens == whole
    assert sum(len(h) for h in whole) > 0
