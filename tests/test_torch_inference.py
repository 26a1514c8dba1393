"""The serving entry point of the port against the JAX package's, at the
small configuration of ``tests/test_torch_decode.py`` (weights from
flax's init, bridged through ``utils/jax_bridge``; waveforms from numpy):

* ``utils/fetching.fetch``: each local strategy; a URL or a Hugging Face
  id raises;
* ``utils/parameter_transfer.Pretrainer``: paths, conditions,
  ``default_source``, ``loaded_paths``; a file whose keys or shapes do not
  fit raises and leaves the module as it was; ``save_for_pretrained``
  after a run of checkpoints, then a ``Pretrainer``, gives the best
  checkpoint's weights bit for bit;
* ``EncoderDecoderASR.transcribe_batch`` against JAX's
  ``EncoderDecoderASR`` built in Python from the same weights, ancestry KV
  on and off: tokens and words equal;
* ``EncoderASR`` against JAX's with a ``CTCTextEncoder`` and with a
  ``SentencePiece`` tokenizer: token ids and words equal;
* ``transcribe_file`` of a 16 kHz and an 8 kHz WAV: the loaded (and
  resampled) samples within 1e-5 of JAX's ``load_audio``, words equal;
* ``from_hparams`` from a YAML through ``foreign_class``: the model's own
  ``custom.py`` builds the beam search over the modules its YAML built,
  and the interface transcribes as JAX's does; on no device asked for, the
  interfaces go to the card (and raise here);
* ``EncodeDecodePipelineMixin``'s pipelines against JAX's.

JAX's interfaces hand their decoder the relative lengths of the waveform;
the port's encoder pads its time axis and hands the rescaled lengths on
(``inference/ASR.py``), so the JAX side is given the same padded lengths
through the closures that play its encoder and decoder. Tolerances: 1e-5
on resampled samples (float32 sums of the same taps in another order);
hypotheses and words exactly. The port runs on the CPU (its kernels'
plain versions)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from speechbrain_tpu.augment.time_domain import Resample as JaxResample
from speechbrain_tpu.dataio.encoder import CTCTextEncoder as JaxCTCText
from speechbrain_tpu.decoders.ctc import (
    ctc_greedy_decode as jax_ctc_greedy_decode,
)
from speechbrain_tpu.inference.ASR import (
    EncoderASR as JaxEncoderASR,
    EncoderDecoderASR as JaxEncoderDecoderASR,
)
from speechbrain_tpu.tokenizers.SentencePiece import (
    SentencePiece as JaxSentencePiece,
)
from speechbrain_tpu.utils.data_utils import (
    pad_time_to_multiple as jax_pad_time,
)
from speechbrain_tpu_torch.augment.time_domain import Resample
from speechbrain_tpu_torch.dataio.dataio import write_audio
from speechbrain_tpu_torch.dataio.encoder import CTCTextEncoder
from speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
from speechbrain_tpu_torch.inference.ASR import EncoderASR
from speechbrain_tpu_torch.inference.interfaces import (
    Pretrained,
    foreign_class,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece
from speechbrain_tpu_torch.utils.checkpoints import Checkpointer
from speechbrain_tpu_torch.utils.fetching import LocalStrategy, fetch
from speechbrain_tpu_torch.utils.parameter_transfer import Pretrainer
from speechbrain_tpu_torch.utils.pretrained import save_for_pretrained
from test_torch_decode import SMALL, JaxStack, _t

RESAMPLE_ATOL = 1e-5
SR = chip_smoke.SR


# -- fetch -------------------------------------------------------------------

@pytest.mark.parametrize("strategy", [LocalStrategy.SYMLINK,
                                      LocalStrategy.COPY,
                                      LocalStrategy.NO_LINK])
def test_fetch_local_strategies(tmp_path, strategy):
    src = tmp_path / "src"
    src.mkdir()
    (src / "model.ckpt").write_text("weights")
    path = fetch("model.ckpt", str(src), savedir=tmp_path / "save",
                 local_strategy=strategy)
    assert path.read_text() == "weights"
    if strategy == LocalStrategy.NO_LINK:
        assert path == (src / "model.ckpt").absolute()
        assert not (tmp_path / "save" / "model.ckpt").exists()
    else:
        assert path == (tmp_path / "save" / "model.ckpt").absolute()
        assert path.is_symlink() == (strategy == LocalStrategy.SYMLINK)
    # a file already in savedir is kept unless overwrite is asked for
    (src / "model.ckpt").write_text("newer")
    kept = fetch("model.ckpt", str(src), savedir=tmp_path / "save",
                 local_strategy=strategy)
    expected = "newer" if strategy != LocalStrategy.COPY else "weights"
    assert kept.read_text() == expected
    with pytest.raises(FileNotFoundError):
        fetch("absent.ckpt", str(src), savedir=tmp_path / "save")


@pytest.mark.parametrize("source", ["https://example.org/models/asr",
                                    "speechbrain/asr-conformer"])
def test_fetch_refuses_remote_sources(tmp_path, source):
    with pytest.raises(ValueError, match="local sources only"):
        fetch("hyperparams.yaml", source, savedir=tmp_path)


# -- Pretrainer --------------------------------------------------------------

def _linear(seed, n_out=3, n_in=4):
    torch.manual_seed(seed)
    return torch.nn.Linear(n_in, n_out)


def test_pretrainer_paths_conditions_and_default_source(tmp_path):
    default, other = tmp_path / "default", tmp_path / "other"
    default.mkdir()
    other.mkdir()
    src = {"a": _linear(1), "b": _linear(2), "c": _linear(3)}
    torch.save(src["a"].state_dict(), other / "weights_a.bin")
    torch.save(src["b"].state_dict(), default / "b.ckpt")
    torch.save(src["c"].state_dict(), default / "c.ckpt")
    dst = {name: _linear(10 + i) for i, name in enumerate(src)}
    before_c = dst["c"].weight.clone()
    pt = Pretrainer(collect_in=tmp_path / "collected", loadables=dst,
                    paths={"a": f"{other}/weights_a.bin"},
                    conditions={"c": lambda: False})
    paths = pt.collect_files(default_source=str(default))
    assert set(paths) == set(pt.loaded_paths) == {"a", "b"}
    assert paths["a"] == (tmp_path / "collected" / "weights_a.bin").absolute()
    pt.load_collected()
    for name in ("a", "b"):
        assert torch.equal(dst[name].weight, src[name].weight)
    assert torch.equal(dst["c"].weight, before_c)
    with pytest.raises(ValueError, match="no default_source"):
        Pretrainer(loadables={"x": _linear(4)}).collect_files()


@pytest.mark.parametrize("fault", ["missing_key", "unexpected_key",
                                   "shape"])
def test_pretrainer_refuses_a_file_that_does_not_fit(tmp_path, fault):
    state = _linear(1).state_dict()
    if fault == "missing_key":
        state.pop("bias")
    elif fault == "unexpected_key":
        state["extra"] = torch.zeros(1)
    else:
        state = _linear(1, n_out=5).state_dict()
    torch.save(state, tmp_path / "lin.ckpt")
    target = _linear(2)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    pt = Pretrainer(collect_in=tmp_path / "c", loadables={"lin": target})
    pt.collect_files(default_source=str(tmp_path))
    with pytest.raises(RuntimeError, match="does not fit"):
        pt.load_collected()
    for k, v in target.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_pretrainer_refuses_an_object_without_a_hook(tmp_path):
    (tmp_path / "thing.ckpt").write_text("x")
    pt = Pretrainer(collect_in=tmp_path / "c", loadables={"thing": object()})
    pt.collect_files(default_source=str(tmp_path))
    with pytest.raises(RuntimeError, match="Don't know how"):
        pt.load_collected()


def test_save_for_pretrained_exports_the_best_checkpoint(tmp_path):
    """Three checkpoints of a model whose valid loss is lowest at the
    second; the export holds that one's weights, and a Pretrainer loads
    them into fresh modules bit for bit."""
    model, head = _linear(1), _linear(2, n_out=2, n_in=3)
    ckpt = Checkpointer(tmp_path / "save",
                        recoverables={"model": model, "head": head})
    best = None
    for step, loss in enumerate([3.0, 1.0, 2.0]):
        with torch.no_grad():
            model.weight.add_(1.0)
            head.bias.add_(step)
        if loss == 1.0:
            best = {"model": {k: v.clone() for k, v in
                              model.state_dict().items()},
                    "head": {k: v.clone() for k, v in
                             head.state_dict().items()}}
        ckpt.save_checkpoint(meta={"loss": loss})
    export = tmp_path / "export"
    hparams = {"checkpointer": ckpt, "pretrainer": Pretrainer(
        loadables={"model": model, "head": head},
        paths={"model": f"{export}/model.ckpt",
               "head": f"{export}/head.ckpt"})}
    save_for_pretrained(hparams, min_key="loss")
    fresh = {"model": _linear(7), "head": _linear(8, n_out=2, n_in=3)}
    pt = Pretrainer(collect_in=tmp_path / "served", loadables=fresh)
    pt.collect_files(default_source=str(export))
    pt.load_collected()
    for name, module in fresh.items():
        for k, v in module.state_dict().items():
            assert torch.equal(v, best[name][k]), (name, k)
    with pytest.raises(ValueError, match="pretrainer"):
        save_for_pretrained({"checkpointer": ckpt})


# -- the interfaces against JAX's ---------------------------------------------

@pytest.fixture(scope="module")
def stack():
    return JaxStack(SMALL)


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """One BPE model file covering the heads' classes, loaded by each
    package's SentencePiece."""
    d = str(tmp_path_factory.mktemp("bpe"))
    chip_smoke.write_covering_bpe(d, SMALL["vocab"])
    return (SentencePiece(d, SMALL["vocab"], model_type="bpe"),
            JaxSentencePiece(d, SMALL["vocab"], model_type="bpe"))


class _JaxSide:
    """JAX's serving stack as the callables its interfaces take: the
    encoder keeps the padded lengths of its last batch for the decoder
    (or the greedy CTC decoding) that follows it."""

    def __init__(self, stack, ancestry=True):
        self.stack, self.ancestry, self.lens_p = stack, ancestry, None

    def states(self, wavs, lens):
        s = self.stack
        feats = s.fbank(jnp.asarray(wavs))
        sub = s.frontend.apply(s.v_fe, feats, train=False)
        sub, self.lens_p = jax_pad_time(sub, jnp.asarray(lens),
                                        multiple=s.C["pad_multiple"])
        return s.net.apply(s.v, sub, wav_len=self.lens_p, method="encode")

    def ctc(self, wavs, lens):
        return self.stack.ctc_fn(self.states(wavs, lens))

    def decoder(self, enc, _lens):
        return self.stack.searcher(self.ancestry)(enc, self.lens_p)

    def greedy(self, log_probs, _lens):
        return jax_ctc_greedy_decode(log_probs, self.lens_p, blank_id=0)


@pytest.mark.parametrize("ancestry", [True, False],
                         ids=["ancestry", "permute"])
def test_encoder_decoder_asr_matches_jax(stack, tokenizers, ancestry):
    tok, jtok = tokenizers
    side = _JaxSide(stack, ancestry)
    jasr = JaxEncoderDecoderASR(hparams={
        "encoder": side.states, "decoder": side.decoder, "tokenizer": jtok})
    jwords, jhyps = jasr.transcribe_batch(jnp.asarray(stack.wavs),
                                          jnp.asarray(stack.lens))
    asr = chip_smoke.served_asr(stack.port(ancestry), tok)
    words, hyps = asr.transcribe_batch(_t(stack.wavs), _t(stack.lens))
    assert hyps == [list(h) for h in jhyps]
    assert words == list(jwords)
    assert all(len(h) > 0 for h in hyps)
    # frozen and in evaluation mode, so no caller needs torch.no_grad()
    decoder = asr.hparams.decoder
    assert not any(p.requires_grad for p in decoder.parameters())
    assert not decoder.lm.training and not asr.hparams.encoder.training


def _ctc_text_encoders():
    """Both packages' CTCTextEncoder over the heads' classes: the blank
    at index 0, a letter for each other class."""
    labels = [chr(ord("a") + i) for i in range(SMALL["vocab"] - 1)]
    out = []
    for cls in (CTCTextEncoder, JaxCTCText):
        enc = cls()
        enc.update_from_iterable(labels)
        enc.insert_blank("<blank>", 0)
        out.append(enc)
    return out


@pytest.mark.parametrize("tokenizer", ["ctc_text_encoder", "sentencepiece"])
def test_encoder_asr_matches_jax(stack, tokenizers, tokenizer):
    if tokenizer == "sentencepiece":
        tok, jtok = tokenizers
    else:
        tok, jtok = _ctc_text_encoders()
    side = _JaxSide(stack)
    jasr = JaxEncoderASR(hparams={
        "encoder": side.ctc, "decoding_function": side.greedy,
        "tokenizer": jtok})
    pipe = stack.port(ancestry=True)
    asr = EncoderASR(hparams={
        "encoder": chip_smoke.served_encoder(pipe, ctc=True),
        "decoding_function": functools.partial(ctc_greedy_decode,
                                               blank_id=0),
        "tokenizer": tok}, run_opts={"device": "cpu"})
    jwords, jhyps = jasr.transcribe_batch(jnp.asarray(stack.wavs),
                                          jnp.asarray(stack.lens))
    words, hyps = asr.transcribe_batch(_t(stack.wavs), _t(stack.lens))
    assert hyps == [list(map(int, h)) for h in jhyps]
    assert words == list(jwords)
    assert sum(len(h) for h in hyps) > 0


@pytest.mark.parametrize("rate", [16000, 8000])
def test_transcribe_file_matches_jax(stack, tmp_path, rate):
    """A 0.5 s WAV written by the port: its samples as each interface
    loads them (resampled to 16 kHz from 8 kHz), then the words."""
    signal = 0.1 * np.random.default_rng(rate).standard_normal(
        rate // 2).astype(np.float32)
    path = tmp_path / f"utt_{rate}.wav"
    write_audio(str(path), signal, rate)
    side = _JaxSide(stack)
    labels = _ctc_text_encoders()
    jasr = JaxEncoderASR(hparams={
        "encoder": side.ctc, "decoding_function": side.greedy,
        "tokenizer": labels[1], "sample_rate": SR})
    asr = EncoderASR(hparams={
        "encoder": chip_smoke.served_encoder(stack.port(True), ctc=True),
        "decoding_function": functools.partial(ctc_greedy_decode,
                                               blank_id=0),
        "tokenizer": labels[0], "sample_rate": SR},
        run_opts={"device": "cpu"})
    loaded, jloaded = asr.load_audio(path), jasr.load_audio(str(path))
    assert loaded.shape == (SR // 2,) and jloaded.shape == loaded.shape
    np.testing.assert_allclose(loaded.numpy(), np.asarray(jloaded),
                               atol=RESAMPLE_ATOL)
    if rate != SR:
        x = np.random.default_rng(1).standard_normal((2, 1001)).astype(
            np.float32)
        np.testing.assert_allclose(
            Resample(rate, SR)(torch.from_numpy(x)).numpy(),
            np.asarray(JaxResample(rate, SR)(jnp.asarray(x))),
            atol=RESAMPLE_ATOL)
    assert asr.transcribe_file(path) == jasr.transcribe_file(str(path))


# -- from_hparams from a YAML, through foreign_class --------------------------

HYPERPARAMS_YAML = """\
# the small configuration of tests/test_torch_decode.py
pretrained_path: !PLACEHOLDER
device: cuda
sample_rate: 16000
vocab: 24
beam: 5
lm_weight: 0.6
ctc_weight: 0.4
temperature: 1.15
max_decode_ratio: 1.0
bos_index: 1
eos_index: 2
blank_index: 0

compute_features: !new:speechbrain_tpu_torch.lobes.features.Fbank
  n_mels: 20
  fused: True
  device: !ref <device>
frontend: !new:speechbrain_tpu_torch.lobes.models.convolution.ConvolutionFrontEnd
  num_blocks: 2
  out_channels: !tuple (8, 4)
  kernel_sizes: !tuple (3, 3)
  strides: !tuple (2, 2)
  device: !ref <device>
asr_model: !new:speechbrain_tpu_torch.lobes.models.transformer.TransformerASR.TransformerASR
  tgt_vocab: !ref <vocab>
  input_size: 20
  d_model: 16
  nhead: 4
  num_encoder_layers: 1
  num_decoder_layers: 2
  d_ffn: 32
  encoder_module: conformer
  attention_type: RelPosMHAXL
  kernel_size: 5
  normalize_before: True
  device: !ref <device>
ctc_lin: !new:speechbrain_tpu_torch.nnet.linear.Linear
  n_neurons: !ref <vocab>
  input_size: 16
  device: !ref <device>
seq_lin: !new:speechbrain_tpu_torch.nnet.linear.Linear
  n_neurons: !ref <vocab>
  input_size: 16
  device: !ref <device>
lm: !new:speechbrain_tpu_torch.lobes.models.transformer.TransformerLM.TransformerLM
  vocab: !ref <vocab>
  d_model: 16
  nhead: 4
  num_encoder_layers: 2
  d_ffn: 32
  dropout: 0.0
  activation: gelu
  normalize_before: False
  device: !ref <device>

encoder: !new:speechbrain_tpu_torch.nnet.containers.LengthsCapableSequential
  layers:
    - !ref <compute_features>
    - !ref <frontend>
    - !name:speechbrain_tpu_torch.utils.data_utils.pad_time_to_multiple
      multiple: 8
    - !new:speechbrain_tpu_torch.lobes.models.transformer.TransformerASR.EncoderWrapper
      transformer: !ref <asr_model>

tokenizer: !new:speechbrain_tpu_torch.tokenizers.SentencePiece.SentencePiece
  model_dir: !ref <pretrained_path>
  vocab_size: !ref <vocab>
  model_type: bpe

modules:
  asr_model: !ref <asr_model>
  ctc_lin: !ref <ctc_lin>
  seq_lin: !ref <seq_lin>
  lm: !ref <lm>

pretrainer: !new:speechbrain_tpu_torch.utils.parameter_transfer.Pretrainer
  loadables:
    frontend: !ref <frontend>
    asr: !ref <asr_model>
    ctc_lin: !ref <ctc_lin>
    seq_lin: !ref <seq_lin>
    lm: !ref <lm>
"""

CUSTOM_PY = '''\
"""The model's own interface: the joint CTC/attention beam search with
LM fusion over the modules its hyperparams.yaml built, sized to each
batch's encoder length."""

import torch

from speechbrain_tpu_torch.decoders.scorer import (
    CTCScorer,
    KVTransformerLMScorer,
    ScorerBuilder,
)
from speechbrain_tpu_torch.decoders.seq2seq import S2SKVBeamSearcher
from speechbrain_tpu_torch.inference.ASR import EncoderDecoderASR


class BeamDecoder(torch.nn.Module):
    def __init__(self, hparams, device):
        super().__init__()
        self.h, self.device = hparams, device
        self.net, self.seq_lin = hparams.asr_model, hparams.seq_lin
        self.ctc_lin, self.lm = hparams.ctc_lin, hparams.lm

    def forward(self, enc, lens):
        h = self.h
        max_steps = max(1, int(enc.shape[1] * h.max_decode_ratio))

        def step(toks, cache, enc_states, enc_lens, i, anc=None):
            out, cache, attn = self.net.decode_step(toks, enc_states, cache,
                                                    i, anc=anc)
            logits = self.seq_lin(out).float()
            return (torch.log_softmax(logits / h.temperature, -1), cache,
                    attn)

        scorer = ScorerBuilder(
            weights={"ctc": h.ctc_weight, "transformerlm": h.lm_weight},
            full_scorers={"transformerlm": KVTransformerLMScorer(
                step_fn=self.lm.score_step, init_cache_fn=self.lm.init_cache,
                max_length=max_steps + 1, temperature=h.temperature,
                ancestry=True)},
            partial_scorers={"ctc": CTCScorer(
                ctc_fn=lambda e: torch.log_softmax(
                    self.ctc_lin(e).float(), -1),
                blank_index=h.blank_index, eos_index=h.eos_index)},
        )
        searcher = S2SKVBeamSearcher(
            step, lambda n, e, l: self.net.init_decoder_cache_with_cross(
                e, max_steps + 1, n),
            shared_cross_kv=True, ancestry_kv=True, bos_index=h.bos_index,
            eos_index=h.eos_index, min_decode_ratio=0.0,
            max_decode_ratio=h.max_decode_ratio, beam_size=h.beam,
            using_eos_threshold=False, length_normalization=True,
            temperature=h.temperature, scorer=scorer, device=self.device)
        return searcher(enc, lens)


class CustomInterface(EncoderDecoderASR):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.hparams.decoder = BeamDecoder(self.hparams, self.device)
        self._prepare_modules()
'''


def _model_source(stack, tmp_path, tokenizers):
    """A model source directory: the YAML, custom.py, the bridged JAX
    weights as each module's state dict, the tokenizer's model."""
    src = tmp_path / "model"
    src.mkdir()
    (src / "hyperparams.yaml").write_text(HYPERPARAMS_YAML)
    (src / "custom.py").write_text(CUSTOM_PY)
    for name, module in chip_smoke.serve_modules(stack.port(True)).items():
        torch.save(module.state_dict(), src / f"{name}.ckpt")
    tokenizers[0].sp.save(str(src / f"{SMALL['vocab']}_bpe.model.json"))
    return src


def test_from_hparams_yaml_through_foreign_class(stack, tokenizers,
                                                 tmp_path):
    src = _model_source(stack, tmp_path, tokenizers)
    asr = foreign_class(
        str(src), pymodule_file="custom.py", classname="CustomInterface",
        savedir=tmp_path / "saved", overrides={"pretrained_path": str(src)},
        run_opts={"device": "cpu"})
    side = _JaxSide(stack, ancestry=True)
    jasr = JaxEncoderDecoderASR(hparams={
        "encoder": side.states, "decoder": side.decoder,
        "tokenizer": tokenizers[1]})
    jwords, jhyps = jasr.transcribe_batch(jnp.asarray(stack.wavs),
                                          jnp.asarray(stack.lens))
    words, hyps = asr.transcribe_batch(_t(stack.wavs), _t(stack.lens))
    assert hyps == [list(h) for h in jhyps] and words == list(jwords)
    assert asr.device.type == "cpu"
    assert all(not m.training for m in asr.mods.values())
    assert not any(p.requires_grad for p in asr.mods.parameters())
    collected = {p.name for p in (tmp_path / "saved").iterdir()}
    assert {"hyperparams.yaml", "custom.py", "asr.ckpt", "lm.ckpt"} <= \
        collected


def test_interfaces_default_to_cuda(tmp_path):
    """Asked for no device, an interface and ``from_hparams`` go to the
    card, and raise where there is none: no quiet CPU carry-on."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    (tmp_path / "hyperparams.yaml").write_text(
        "device: cuda\n"
        "lin: !new:speechbrain_tpu_torch.nnet.linear.Linear\n"
        "  n_neurons: 2\n  input_size: 2\n  device: !ref <device>\n"
        "modules:\n  lin: !ref <lin>\n")
    for build in (
        lambda: Pretrained(modules={"lin": torch.nn.Linear(2, 2)}),
        lambda: EncoderASR(hparams={"encoder": torch.nn.Linear(2, 2),
                                    "decoding_function": None,
                                    "tokenizer": None}),
        lambda: Pretrained.from_hparams(str(tmp_path),
                                        savedir=tmp_path / "s"),
    ):
        with pytest.raises((RuntimeError, AssertionError)):
            build()
    served = Pretrained.from_hparams(str(tmp_path), savedir=tmp_path / "c",
                                     run_opts={"device": "cpu"})
    assert served.mods.lin.weight.device.type == "cpu"
    assert pathlib.Path(tmp_path / "c" / "hyperparams.yaml").is_symlink()


def test_encode_decode_pipeline_mixin_matches_jax():
    """The mixin's pipelines, named in hparams, in both packages: the same
    steps give the same encoded input and decoded output."""
    from speechbrain_tpu.inference.interfaces import (
        EncodeDecodePipelineMixin as JaxMixin,
        Pretrained as JaxPretrained,
    )
    from speechbrain_tpu_torch.inference.interfaces import (
        EncodeDecodePipelineMixin,
    )

    hparams = {
        "encode_pipeline": {
            "steps": [{"func": str.split, "takes": "txt",
                       "provides": "words"},
                      {"func": len, "takes": "words", "provides": "n"}],
            "output_keys": ["words", "n"]},
        "decode_pipeline": {
            "steps": [{"func": lambda ids: "-".join(map(str, ids)),
                       "takes": "ids", "provides": "text"}],
            "output_keys": ["text"]},
        "model_output_keys": ["ids"],
    }
    results = []
    for base, mixin, kw in ((JaxPretrained, JaxMixin, {}),
                            (Pretrained, EncodeDecodePipelineMixin,
                             {"run_opts": {"device": "cpu"}})):
        class Interface(mixin, base):
            INPUT_STATIC_KEYS = ["txt"]
            OUTPUT_KEYS = ["text"]

        model = Interface(hparams=hparams, **kw)
        model.create_pipelines()
        results.append((model.encode_input({"txt": "a bb ccc"}),
                        model.decode_output({"ids": [3, 1, 4]})))
    assert results[1] == results[0]
    assert results[1][0] == {"words": ["a", "bb", "ccc"], "n": 3}
    assert results[1][1] == {"text": "3-1-4"}
