"""Recurrent seq2seq ASR as a whole against the JAX package at a small size:
the ``CRDNN`` encoder (LSTM and SLi-GRU, evaluation and training mode with
its running statistics), the ``RNNLM`` (whole sequence, and step by step
through its state), the RNN searchers fused with the CTC, RNNLM, coverage
and length scorers (greedy and beam), the slice from waveform to tokens
through ``EncoderDecoderASR``, and ``EncoderDecoderASR.from_hparams`` from
a YAML. Weights are drawn with numpy into the shapes of flax's variables
and carried into the port through ``utils/jax_bridge``.

The JAX features come from its unfused ``Fbank``, the port's from the
fused one (on the CPU its plain version); they differ by about 1e-4 dB.
Tolerances: 1e-5 absolute on module outputs and running statistics
(float32 on both sides), but 5e-5 on the CRDNN's output in training mode:
there its BatchNorms normalise by the statistics of 14 rows, and the JAX
package's own float32 output lies 1.4e-5 from a float64 run of the same
weights (the port's 7e-6); 1e-4 on search scores (summed over up to 25
steps; the JAX CTC prefix scorer reads its posteriors through a bf16
hi/lo split, ROADMAP.md C6). Hypotheses must be equal token for token."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from speechbrain_tpu.decoders import scorer as jscorer
from speechbrain_tpu.decoders import seq2seq as jseq
from speechbrain_tpu.lobes.features import Fbank as JaxFbank
from speechbrain_tpu.lobes.models.CRDNN import CRDNN as JaxCRDNN
from speechbrain_tpu.lobes.models.RNNLM import RNNLM as JaxRNNLM
from speechbrain_tpu.nnet.embedding import Embedding as JaxEmbedding
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.RNN import AttentionalRNNDecoder as JaxDecoder
from speechbrain_tpu.processing.features import (
    InputNormalization as JaxNorm,
)
from speechbrain_tpu_torch.decoders.seq2seq import S2SRNNGreedySearcher
from speechbrain_tpu_torch.inference.ASR import EncoderDecoderASR
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN
from speechbrain_tpu_torch.lobes.models.RNNLM import RNNLM
from speechbrain_tpu_torch.nnet.containers import LengthsCapableSequential
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.RNN import AttentionalRNNDecoder
from speechbrain_tpu_torch.processing.features import InputNormalization
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq import train
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import _close, _jax, _t, _x, draw_variables, japply

SCORE_ATOL = 1e-4
TRAIN_MODE_ATOL = 5e-5
S = dict(n_mels=16, channels=(4, 8), rnn_layers=2, rnn=8, dnn=12, emb=8,
         dec=10, attn=6, loc_channels=3, loc_kernel=5, vocab=20, bos=0,
         eos=0, blank=0, lm_emb=6, lm_rnn=12, lm_dnn=8)
# the decode settings of the chip's crdnn_path, scaled: beam 4
FUSION = dict(beam_size=4, min_decode_ratio=0.0, max_decode_ratio=1.0,
              eos_threshold=1.5, using_max_attn_shift=True, max_attn_shift=6,
              ctc_weight=0.4, lm_weight=0.5, coverage_penalty=1.5,
              temperature=1.25, temperature_lm=1.25)
# coverage and the length reward, no eos threshold, no length norm
LENGTH = dict(beam_size=3, min_decode_ratio=0.2, max_decode_ratio=0.8,
              using_eos_threshold=False, length_normalization=False,
              coverage_penalty=0.5, length_reward=0.3)
WAV_LENS = np.array([1.0, 0.7], np.float32)


def _crdnn_kwargs(rnn_class):
    return dict(cnn_channels=S["channels"], inter_layer_pooling_size=(2, 2),
                time_pooling=True, time_pooling_size=2, rnn_class=rnn_class,
                rnn_layers=S["rnn_layers"], rnn_neurons=S["rnn"],
                dnn_blocks=1, dnn_neurons=S["dnn"])


def _crdnn_pair(rnn_class, dropout=0.0):
    feats = _x((2, 14, S["n_mels"]))
    jm = JaxCRDNN(dropout=dropout, **_crdnn_kwargs(rnn_class))
    variables = draw_variables(jm, jnp.asarray(feats), train=False)
    tm = CRDNN(input_size=S["n_mels"], dropout=dropout, device="cpu",
               **_crdnn_kwargs(rnn_class))
    load(tm, variables)
    return jm, tm, variables, feats


@pytest.mark.parametrize("rnn_class", ["lstm", "sligru"])
def test_crdnn_matches_jax(rnn_class):
    """Evaluation mode, then one training-mode forward at dropout 0: the
    output and every running statistic against flax's updated
    ``batch_stats``."""
    jm, tm, variables, feats = _crdnn_pair(rnn_class)
    _close(tm.eval()(_t(feats)),
           japply(jm, variables, jnp.asarray(feats), train=False))
    j_out, j_new = japply(jm, variables, jnp.asarray(feats), train=True,
                          mutable=["batch_stats"])
    _close(tm.train()(_t(feats)), j_out, TRAIN_MODE_ATOL)
    ref = CRDNN(input_size=S["n_mels"], dropout=0.0, device="cpu",
                **_crdnn_kwargs(rnn_class))
    load(ref, {"params": variables["params"],
               "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                     j_new["batch_stats"])})
    for (name, a), (_, b) in zip(tm.named_buffers(), ref.named_buffers()):
        if name.endswith(("running_mean", "running_var")):
            _close(a, b.numpy())


def test_crdnn_training_dropout_draws_and_shapes():
    """With dropout the training forward differs from evaluation and keeps
    its shape; in evaluation the dropout is the identity."""
    _, tm, _, feats = _crdnn_pair("lstm", dropout=0.5)
    torch.manual_seed(0)
    train_out = tm.train()(_t(feats))
    eval_out = tm.eval()(_t(feats))
    assert train_out.shape == eval_out.shape == (2, 7, S["dnn"])
    assert not torch.allclose(train_out, eval_out)
    assert torch.equal(tm(_t(feats)), eval_out)


def _lm_pair():
    jlm = JaxRNNLM(output_neurons=S["vocab"], embedding_dim=S["lm_emb"],
                   rnn_neurons=S["lm_rnn"], dnn_neurons=S["lm_dnn"],
                   dropout=0.0)
    tokens = np.random.default_rng(3).integers(0, S["vocab"], (3, 6))
    variables = draw_variables(jlm, jnp.asarray(tokens))
    tlm = RNNLM(S["vocab"], S["lm_emb"], rnn_neurons=S["lm_rnn"],
                dnn_neurons=S["lm_dnn"], dropout=0.0, device="cpu").eval()
    load(tlm, variables)
    return jlm, tlm, variables, tokens


def test_rnnlm_matches_jax_whole_and_step_by_step():
    jlm, tlm, variables, tokens = _lm_pair()
    j_logits, (j_h, j_c) = japply(jlm, variables, jnp.asarray(tokens))
    logits, (h, c) = tlm(_t(tokens))
    _close(logits, j_logits)
    _close(h, j_h)
    _close(c, j_c)
    state, steps = None, []
    for u in range(tokens.shape[1]):
        out, state = tlm(_t(tokens[:, u:u + 1]), hx=state)
        steps.append(out)
    _close(torch.cat(steps, dim=1), j_logits)
    _close(state[0], j_h)
    _close(state[1], j_c)


# -- the search and the slice ---------------------------------------------

class _Stack:
    """The small model on both sides: JAX modules with drawn variables,
    the port's modules loaded from them, NORTH-shaped waveforms."""

    def __init__(self):
        rng = np.random.default_rng(11)
        self.wavs = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
        self.lens = WAV_LENS
        self.jfbank = JaxFbank(n_mels=S["n_mels"])
        self.jnorm = JaxNorm(norm_type="sentence")
        feats = self.jnorm(self.jfbank(jnp.asarray(self.wavs)),
                           jnp.asarray(self.lens))
        self.jenc = JaxCRDNN(dropout=0.0, **_crdnn_kwargs("lstm"))
        self.v_enc = draw_variables(self.jenc, feats, train=False)
        self.enc_states = japply(self.jenc, self.v_enc, feats, train=False)
        T = self.enc_states.shape[1]
        self.jemb = JaxEmbedding(num_embeddings=S["vocab"],
                                 embedding_dim=S["emb"])
        self.jdec = JaxDecoder(hidden_size=S["dec"], attn_dim=S["attn"],
                               attn_type="location",
                               channels=S["loc_channels"],
                               kernel_size=S["loc_kernel"])
        self.jseq, self.jctc = JaxLinear(S["vocab"]), JaxLinear(S["vocab"])
        ids = jnp.zeros((2, 3), jnp.int32)
        self.v_emb = draw_variables(self.jemb, ids, seed=2)
        emb = self.jemb.apply(_jax(self.v_emb), ids)
        self.v_dec = draw_variables(self.jdec, emb, self.enc_states,
                                    jnp.asarray(self.lens), seed=3)
        self.v_seq = draw_variables(self.jseq, jnp.zeros((1, S["dec"])),
                                    seed=4)
        self.v_ctc = draw_variables(self.jctc, jnp.zeros((1, S["dnn"])),
                                    seed=5)
        self.jlm, self.lm, self.v_lm, _ = _lm_pair()
        kw = dict(device="cpu")
        self.modules = {
            "enc": CRDNN(input_size=S["n_mels"], dropout=0.0, **kw,
                         **_crdnn_kwargs("lstm")),
            "emb": Embedding(S["vocab"], S["emb"], **kw),
            "dec": AttentionalRNNDecoder(
                hidden_size=S["dec"], attn_dim=S["attn"],
                input_size=S["emb"], enc_dim=S["dnn"],
                channels=S["loc_channels"], kernel_size=S["loc_kernel"],
                **kw),
            "seq_lin": Linear(S["vocab"], S["dec"], **kw),
            "ctc_lin": Linear(S["vocab"], S["dnn"], **kw),
        }
        for name, v in (("enc", self.v_enc), ("emb", self.v_emb),
                        ("dec", self.v_dec), ("seq_lin", self.v_seq),
                        ("ctc_lin", self.v_ctc)):
            load(self.modules[name], v)
        for m in self.modules.values():
            m.eval()
        self.T = T

    # the JAX side, built as the JAX recipe's make_searcher builds it
    def jax_searcher(self, settings, greedy=False):
        s = dict(settings)
        temperature = s.pop("temperature", 1.0)
        temperature_lm = s.pop("temperature_lm", 1.0)
        weights, full, partial = {}, {}, {}
        v_emb, v_dec = _jax(self.v_emb), _jax(self.v_dec)
        v_seq, v_ctc, v_lm = _jax(self.v_seq), _jax(self.v_ctc), \
            _jax(self.v_lm)
        if s.get("ctc_weight", 0) > 0:
            weights["ctc"] = s["ctc_weight"]
            partial["ctc"] = jscorer.CTCScorer(
                lambda x: jax.nn.log_softmax(self.jctc.apply(v_ctc, x), -1),
                blank_index=S["blank"], eos_index=S["eos"])
        if s.get("lm_weight", 0) > 0:
            def lm_fn(tokens, state):
                hx = jax.tree_util.tree_map(lambda t: jnp.moveaxis(t, 0, 1),
                                            state)
                logits, new = self.jlm.apply(v_lm, tokens, hx=hx)
                return logits, jax.tree_util.tree_map(
                    lambda t: jnp.moveaxis(t, 0, 1), new)

            def lm_init(n):
                z = jnp.zeros((n, 2, S["lm_rnn"]))
                return (z, z)

            weights["rnnlm"] = s["lm_weight"]
            full["rnnlm"] = jscorer.RNNLMScorer(lm_fn, lm_init,
                                                temperature=temperature_lm)
        if s.get("coverage_penalty", 0) > 0:
            weights["coverage"] = s["coverage_penalty"]
            full["coverage"] = jscorer.CoverageScorer(vocab_size=S["vocab"])
        if s.get("length_reward", 0) > 0:
            weights["length"] = s["length_reward"]
            full["length"] = jscorer.LengthScorer(vocab_size=S["vocab"])
        for key in ("ctc_weight", "lm_weight", "coverage_penalty",
                    "length_reward"):
            s.pop(key, None)

        def step_fn(inp_tokens, memory, enc_states, enc_lens):
            e = self.jemb.apply(v_emb, inp_tokens[:, None])[:, 0]
            out, new_state, attn = self.jdec.apply(
                v_dec, e, memory, enc_states, enc_lens,
                method="forward_step")
            logits = self.jseq.apply(v_seq, out)
            return jax.nn.log_softmax(logits / temperature, -1), new_state, \
                attn

        def init_fn(batch_size, enc_states, enc_lens):
            state = self.jdec.init_state(batch_size, enc_states.shape[1])
            T = enc_states.shape[1]
            mask0 = (jnp.arange(T)[None, :]
                     < jnp.round(enc_lens * T)[:, None]).astype(jnp.float32)
            state["prev_attn"] = mask0 / jnp.maximum(
                mask0.sum(-1, keepdims=True), 1.0)
            return state

        common = dict(step_fn=step_fn, init_fn=init_fn,
                      bos_index=S["bos"], eos_index=S["eos"])
        if greedy:
            return jseq.S2SRNNGreedySearcher(
                min_decode_ratio=0.0, max_decode_ratio=1.0, **common)
        scorer = (jscorer.ScorerBuilder(weights=weights, full_scorers=full,
                                        partial_scorers=partial)
                  if weights else None)
        return jseq.S2SRNNBeamSearcher(scorer=scorer, **common, **s)

    def port_decoder(self, settings):
        return train.RNNSearchDecoder(
            self.modules["emb"], self.modules["dec"],
            self.modules["seq_lin"], ctc_lin=self.modules["ctc_lin"],
            lm=self.lm, bos_index=S["bos"], eos_index=S["eos"],
            blank_index=S["blank"], vocab_size=S["vocab"], **settings)


@pytest.fixture(scope="module")
def stack():
    return _Stack()


@pytest.fixture(scope="module")
def jax_fusion(stack):
    """The JAX beam search fused with CTC, the RNNLM and coverage over the
    JAX encoder's states of the waveforms."""
    hyps, _, scores, _ = stack.jax_searcher(FUSION)(
        stack.enc_states, jnp.asarray(stack.lens))
    return [list(h) for h in hyps], np.asarray(scores)


def test_fused_beam_search_matches_jax(stack, jax_fusion):
    """CTC 0.4, RNNLM 0.5, coverage 1.5, temperatures 1.25, eos threshold
    and max_attn_shift, over the same encoder states."""
    hyps, _, scores, _ = stack.port_decoder(FUSION)(
        _t(stack.enc_states), _t(stack.lens))
    assert hyps == jax_fusion[0]
    np.testing.assert_allclose(scores, jax_fusion[1], atol=SCORE_ATOL)
    assert max(len(h) for h in hyps) > 0


def test_length_and_coverage_beam_search_matches_jax(stack):
    j_hyps, _, j_scores, _ = stack.jax_searcher(LENGTH)(
        stack.enc_states, jnp.asarray(stack.lens))
    hyps, _, scores, _ = stack.port_decoder(LENGTH)(
        _t(stack.enc_states), _t(stack.lens))
    assert hyps == [list(h) for h in j_hyps]
    np.testing.assert_allclose(scores, np.asarray(j_scores),
                               atol=SCORE_ATOL)


def test_greedy_search_matches_jax(stack):
    j_hyps, _, j_scores, _ = stack.jax_searcher({}, greedy=True)(
        stack.enc_states, jnp.asarray(stack.lens))
    step_fn, init_fn = train.rnn_search_fns(
        stack.modules["emb"], stack.modules["dec"], stack.modules["seq_lin"])
    searcher = S2SRNNGreedySearcher(step_fn, init_fn, bos_index=S["bos"],
                                    eos_index=S["eos"], device="cpu")
    hyps, _, scores, _ = searcher(_t(stack.enc_states), _t(stack.lens))
    assert hyps == [list(h) for h in j_hyps]
    np.testing.assert_allclose(scores, np.asarray(j_scores),
                               atol=SCORE_ATOL)


def _tokenizer(tmp_path):
    chip_smoke.write_covering_bpe(str(tmp_path), S["vocab"])
    return SentencePiece(str(tmp_path), S["vocab"], model_type="bpe")


def test_the_slice_from_waveform_to_tokens(stack, jax_fusion, tmp_path):
    """``EncoderDecoderASR`` over ``LengthsCapableSequential(Fbank(fused),
    InputNormalization, CRDNN)`` and the fused search: the JAX encoder's
    states, and the tokens of the JAX search on them."""
    encoder = LengthsCapableSequential([
        Fbank(n_mels=S["n_mels"], fused=True, device="cpu"),
        InputNormalization(norm_type="sentence"),
        stack.modules["enc"],
    ])
    asr = EncoderDecoderASR(hparams={
        "encoder": encoder, "decoder": stack.port_decoder(FUSION),
        "tokenizer": _tokenizer(tmp_path), "sample_rate": 16000,
    }, run_opts={"device": "cpu"})
    _close(asr.encode_batch(_t(stack.wavs), _t(stack.lens)),
           stack.enc_states, 1e-4)
    words, hyps = asr.transcribe_batch(_t(stack.wavs), _t(stack.lens))
    assert hyps == jax_fusion[0]
    assert len(words) == 2


HYPERPARAMS_YAML = """\
# a CRDNN seq2seq model at the size of tests/test_torch_crdnn.py
device: cuda
sample_rate: 16000
n_mels: 16
vocab: 20

compute_features: !new:speechbrain_tpu_torch.lobes.features.Fbank
  n_mels: !ref <n_mels>
  fused: True
  device: !ref <device>
normalize: !new:speechbrain_tpu_torch.processing.features.InputNormalization
  norm_type: sentence
enc: !new:speechbrain_tpu_torch.lobes.models.CRDNN.CRDNN
  input_size: !ref <n_mels>
  cnn_channels: !tuple (4, 8)
  inter_layer_pooling_size: !tuple (2, 2)
  time_pooling: True
  time_pooling_size: 2
  rnn_layers: 2
  rnn_neurons: 8
  dnn_blocks: 1
  dnn_neurons: 12
  dropout: 0.0
  device: !ref <device>
emb: !new:speechbrain_tpu_torch.nnet.embedding.Embedding
  num_embeddings: !ref <vocab>
  embedding_dim: 8
  device: !ref <device>
dec: !new:speechbrain_tpu_torch.nnet.RNN.AttentionalRNNDecoder
  hidden_size: 10
  attn_dim: 6
  input_size: 8
  enc_dim: 12
  channels: 3
  kernel_size: 5
  device: !ref <device>
seq_lin: !new:speechbrain_tpu_torch.nnet.linear.Linear
  n_neurons: !ref <vocab>
  input_size: 10
  device: !ref <device>
ctc_lin: !new:speechbrain_tpu_torch.nnet.linear.Linear
  n_neurons: !ref <vocab>
  input_size: 12
  device: !ref <device>
lm: !new:speechbrain_tpu_torch.lobes.models.RNNLM.RNNLM
  output_neurons: !ref <vocab>
  embedding_dim: 6
  rnn_neurons: 12
  dnn_neurons: 8
  dropout: 0.0
  device: !ref <device>

encoder: !new:speechbrain_tpu_torch.nnet.containers.LengthsCapableSequential
  layers: [!ref <compute_features>, !ref <normalize>, !ref <enc>]
decoder: !new:speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq.train.RNNSearchDecoder
  emb: !ref <emb>
  dec: !ref <dec>
  seq_lin: !ref <seq_lin>
  ctc_lin: !ref <ctc_lin>
  lm: !ref <lm>
  bos_index: 0
  eos_index: 0
  blank_index: 0
  vocab_size: !ref <vocab>
  beam_size: 4
  min_decode_ratio: 0.0
  max_decode_ratio: 1.0
  eos_threshold: 1.5
  using_max_attn_shift: True
  max_attn_shift: 6
  ctc_weight: 0.4
  lm_weight: 0.5
  coverage_penalty: 1.5
  temperature: 1.25
  temperature_lm: 1.25
tokenizer: !new:speechbrain_tpu_torch.tokenizers.SentencePiece.SentencePiece
  model_dir: !ref <pretrained_path>
  vocab_size: !ref <vocab>
  model_type: bpe
pretrained_path: !PLACEHOLDER

modules:
  encoder: !ref <encoder>
  decoder: !ref <decoder>

pretrainer: !new:speechbrain_tpu_torch.utils.parameter_transfer.Pretrainer
  loadables:
    enc: !ref <enc>
    emb: !ref <emb>
    dec: !ref <dec>
    seq_lin: !ref <seq_lin>
    ctc_lin: !ref <ctc_lin>
    lm: !ref <lm>
"""


def test_from_hparams_yaml(stack, jax_fusion, tmp_path):
    """A model source directory (the YAML above, each module's state dict,
    the running statistics inside the encoder's, the tokenizer) served by
    ``EncoderDecoderASR.from_hparams`` on the CPU: the JAX search's
    tokens."""
    src = tmp_path / "model"
    src.mkdir()
    (src / "hyperparams.yaml").write_text(HYPERPARAMS_YAML)
    for name, module in {**stack.modules, "lm": stack.lm}.items():
        torch.save(module.state_dict(), src / f"{name}.ckpt")
    _tokenizer(src)
    asr = EncoderDecoderASR.from_hparams(
        source=str(src), savedir=tmp_path / "saved",
        overrides={"pretrained_path": str(src)},
        run_opts={"device": "cpu"})
    words, hyps = asr.transcribe_batch(_t(stack.wavs), _t(stack.lens))
    assert hyps == jax_fusion[0]
    assert all(not m.training for m in asr.mods.values())
    enc = asr.hparams.enc
    assert torch.equal(enc.dnn_norms[0].running_var,
                       stack.modules["enc"].dnn_norms[0].running_var)
