"""The LibriSpeech transformer recipe's other encoder families against the
JAX package at a small size: ``RoPEMHA``, ``HyperMixing``, the Branchformer
encoder, the ``1dcnn`` FFN, ``ConformerDecoder``,
``TransformerLM.embed_tokens``/``forward_embeds``; ``TransformerASR``
(encode, forward, decode_step) under the five encoder/attention
combinations of the recipe's YAMLs (``test_torch_family_asr.py``, which
takes its helpers from here); the greedy searchers and the
token-buffer beam searcher; a head-dim-18 model (the d-144, 8-head
configurations scaled down) served through ``chip_smoke.Pipeline``'s
ancestry search with B1's plain version; and remat. Weights are drawn with
numpy into the shapes of flax's parameter tree (``jax.eval_shape`` of its
init, which compiles nothing) and carried into the port through
``utils/jax_bridge``; inputs come from numpy.

Tolerances: 1e-5 absolute on module outputs (float32 on both sides, one or
two layers, sums in another order); 1e-4 on the outputs of whole models and
on search scores (a few layers deep and summed over up to 24 steps; the JAX
CTC prefix scorer also reads its posteriors through a bf16 hi/lo split,
ROADMAP.md C6). Hypotheses must be equal token for token."""

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
from speechbrain_tpu.lobes.models.Branchformer import (
    BranchformerEncoder as JaxBranchformer,
)
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JaxFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.Conformer import (
    ConformerDecoder as JaxConformerDecoder,
)
from speechbrain_tpu.lobes.models.transformer.Transformer import (
    TransformerEncoderLayer as JaxEncoderLayer,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JaxASR,
)
from speechbrain_tpu.lobes.models.transformer.TransformerLM import (
    TransformerLM as JaxLM,
)
from speechbrain_tpu.nnet.attention import RelPosEncXL as JaxRelPosEncXL
from speechbrain_tpu.nnet.attention import RoPEMHA as JaxRoPEMHA
from speechbrain_tpu.nnet.hypermixing import HyperMixing as JaxHyperMixing
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.utils.data_utils import (
    pad_time_to_multiple as jax_pad_time,
)
from speechbrain_tpu_torch.decoders import seq2seq
from speechbrain_tpu_torch.lobes.models.Branchformer import (
    BranchformerEncoder,
)
from speechbrain_tpu_torch.lobes.models.transformer import (
    Branchformer as transformer_branchformer,
)
from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
    ConformerDecoder,
)
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerEncoderLayer,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    TransformerASR,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
    TransformerLM,
)
from speechbrain_tpu_torch.nnet.attention import RelPosEncXL, RoPEMHA
from speechbrain_tpu_torch.nnet.hypermixing import HyperMixing
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.ops import beam_attention
from speechbrain_tpu_torch.utils.jax_bridge import load

ATOL = 1e-5
MODEL_ATOL = 1e-4
V = 24
BOS, EOS = 1, 2
KEY = jax.random.PRNGKey(0)


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(module, *args, seed=1, **kwargs):
    """Random variables in the shapes of ``module.init(KEY, *args)``: layer
    norm scales about 1, biases and other vectors about 0, embeddings
    N(0, 1), weight kernels N(0, 1/fan_in)."""
    shapes = jax.eval_shape(
        lambda *a: module.init(KEY, *a, **kwargs), *args
    )
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "embedding":
            return n
        if name == "kernel":
            return n / np.sqrt(np.prod(leaf.shape[:-1]))
        return 0.1 * n

    return jax.tree_util.tree_map(
        jnp.asarray, jax.tree_util.tree_map_with_path(draw, shapes)
    )


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(
        torch_out.detach().numpy(), np.asarray(jax_out), atol=atol
    )


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32
    )


PAD = np.array([[False] * 9, [False] * 6 + [True] * 3])


# -- modules ----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_rope_mha(masked):
    x = _x((2, 9, 16))
    kpm = PAD if masked else None
    jm = JaxRoPEMHA(nhead=2, d_model=16)
    v = _params(jm, x, x, x)
    ref, ref_w = jm.apply(v, x, x, x, key_padding_mask=kpm)
    m = load(RoPEMHA(nhead=2, d_model=16, device="cpu"), _np_tree(v))
    with torch.no_grad():
        out, w = m(_t(x), _t(x), _t(x),
                   key_padding_mask=None if kpm is None else _t(kpm))
    _close(out, ref)
    _close(w, ref_w)


def test_hypermixing_with_padding():
    x = _x((2, 9, 16))
    q = _x((2, 9, 16), seed=1)
    jm = JaxHyperMixing(input_output_dim=16, hypernet_size=24, num_heads=2)
    v = _params(jm, q, x, x)
    ref, ref_w = jm.apply(v, q, x, x, key_padding_mask=PAD)
    m = load(HyperMixing(input_output_dim=16, hypernet_size=24, num_heads=2,
                         device="cpu"), _np_tree(v))
    with torch.no_grad():
        out, w = m(_t(q), _t(x), _t(x), key_padding_mask=_t(PAD))
    assert w is None and ref_w is None
    _close(out, ref)


@pytest.mark.parametrize("attention_type", ["RelPosMHAXL", "hypermixing"])
def test_branchformer_encoder(attention_type):
    x = _x((2, 9, 16))
    kw = dict(num_layers=2, d_model=16, nhead=2, kernel_size=5,
              attention_type=attention_type, csgu_linear_units=32)
    je = JaxBranchformer(**kw)
    pe = JaxRelPosEncXL(emb_dim=16)(x)
    v = _params(je, x, pos_embs=pe)
    ref, _ = je.apply(v, x, src_key_padding_mask=PAD, pos_embs=pe)
    enc = load(BranchformerEncoder(**kw, device="cpu"), _np_tree(v))
    assert transformer_branchformer.BranchformerEncoder is BranchformerEncoder
    with torch.no_grad():
        out, _ = enc(_t(x), src_key_padding_mask=_t(PAD),
                     pos_embs=RelPosEncXL(16)(_t(x)))
    _close(out, ref)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_1dcnn_encoder_layer(normalize_before):
    x = _x((2, 9, 16))
    kw = dict(d_ffn=24, nhead=2, d_model=16, ffn_type="1dcnn",
              ffn_cnn_kernel_size_list=(3, 5),
              normalize_before=normalize_before)
    jl = JaxEncoderLayer(**kw)
    v = _params(jl, x)
    ref, ref_w = jl.apply(v, x, src_key_padding_mask=PAD)
    layer = load(TransformerEncoderLayer(**kw, device="cpu"), _np_tree(v))
    with torch.no_grad():
        out, w = layer(_t(x), src_key_padding_mask=_t(PAD))
    _close(out, ref)
    _close(w, ref_w)


def test_conformer_decoder():
    tgt, mem = _x((2, 5, 16)), _x((2, 9, 16), seed=1)
    mask = np.triu(np.ones((5, 5), bool), k=1)
    jd = JaxConformerDecoder(num_layers=2, d_model=16, d_ffn=32, nhead=2)
    v = _params(jd, tgt, mem, tgt_mask=mask)
    ref, _, ref_cross = jd.apply(v, tgt, mem, tgt_mask=mask,
                                 memory_key_padding_mask=PAD)
    dec = load(ConformerDecoder(num_layers=2, d_model=16, d_ffn=32, nhead=2,
                                device="cpu"), _np_tree(v))
    with torch.no_grad():
        out, _, cross = dec(_t(tgt), _t(mem), tgt_mask=_t(mask),
                            memory_key_padding_mask=_t(PAD))
    _close(out, ref)
    _close(cross[-1], ref_cross[-1])


def test_lm_embed_tokens_and_forward_embeds():
    kw = dict(vocab=V, d_model=16, nhead=2, num_encoder_layers=2, d_ffn=32,
              d_embedding=8)
    ids = np.random.default_rng(3).integers(0, V, (2, 6)).astype(np.int32)
    jlm = JaxLM(**kw)
    v = _params(jlm, ids)
    lm = load(TransformerLM(**kw, device="cpu").eval(), _np_tree(v))
    ref_emb = jlm.apply(v, ids, method="embed_tokens")
    audio = _x((2, 3, 16), seed=4)
    stream = np.concatenate([audio, np.asarray(ref_emb)], axis=1)
    ref = jlm.apply(v, stream, method="forward_embeds")
    with torch.no_grad():
        emb = lm.embed_tokens(_t(ids).long())
        out = lm.forward_embeds(torch.cat([_t(audio), emb], dim=1))
        whole = lm(_t(ids).long())
    _close(emb, ref_emb)
    _close(out, ref, atol=MODEL_ATOL)
    # embedding the ids and scoring them is the LM's own forward
    _close(lm.forward_embeds(emb).detach(), whole)


# -- TransformerASR under the recipe's five encoder/attention combinations --

FAMILIES = {
    "transformer": dict(encoder_module="transformer",
                        attention_type="regularMHA"),
    "conformer_rope": dict(encoder_module="conformer",
                           attention_type="RoPEMHA"),
    "branchformer": dict(encoder_module="branchformer",
                         attention_type="RelPosMHAXL"),
    "hyperconformer": dict(encoder_module="conformer",
                           attention_type="hypermixing"),
    "hyperbranchformer": dict(encoder_module="branchformer",
                              attention_type="hypermixing"),
}


def _asr_kw(name):
    return dict(tgt_vocab=V, input_size=20, d_model=16, nhead=2,
                num_encoder_layers=2, num_decoder_layers=2, d_ffn=32,
                kernel_size=5, **FAMILIES[name])


def _asr(name):
    kw = _asr_kw(name)
    rng = np.random.default_rng(2)
    src = rng.standard_normal((2, 12, 20)).astype(np.float32)
    tok = rng.integers(0, V, (2, 5)).astype(np.int32)
    lens = np.array([1.0, 0.75], np.float32)
    jnet = JaxASR(**kw)
    v = _params(jnet, jnp.asarray(src), jnp.asarray(tok))
    net = load(TransformerASR(**kw, device="cpu").eval(), _np_tree(v))
    jenc = jnet.apply(v, jnp.asarray(src), jnp.asarray(lens), method="encode")
    return jnet, v, net, src, tok, lens, jenc



# -- searchers ---------------------------------------------------------------

class _JaxTableGreedy(jseq.S2SGreedySearcher):
    """S2SGreedySearcher over a fixed table of logits: step, previous
    token and the encoder states pick each step's scores."""

    def __init__(self, table, **kw):
        super().__init__(**kw)
        self.table = jnp.asarray(table)
        self.vocab_size = table.shape[-1]

    def reset_mem(self, batch_size, enc_states, enc_lens):
        return {"n": jnp.zeros((batch_size,), jnp.int32)}

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens, step):
        T = enc_states.shape[1]
        logits = (self.table[step % self.table.shape[0]][inp_tokens]
                  + jnp.take(enc_states, step % T, axis=1))
        return (jax.nn.log_softmax(logits, -1), {"n": memory["n"] + 1},
                None)


class _TableGreedy(seq2seq.S2SGreedySearcher):
    def __init__(self, table, **kw):
        super().__init__(**kw)
        self.table = _t(table)

    def reset_mem(self, batch_size, enc_states, enc_lens):
        return {"n": torch.zeros(batch_size, dtype=torch.int32)}

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens, step):
        T = enc_states.shape[1]
        logits = (self.table[step % self.table.shape[0]][inp_tokens.long()]
                  + enc_states[:, step % T])
        return (torch.log_softmax(logits, -1), {"n": memory["n"] + 1},
                None)


def _same_greedy(out, ref):
    assert out[0] == ref[0]
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[2], ref[2], atol=MODEL_ATOL)
    np.testing.assert_allclose(out[3], np.asarray(ref[3]), atol=MODEL_ATOL)


def test_greedy_searcher_masks_finished_rows_like_jax():
    rng = np.random.default_rng(7)
    table = 2.0 * rng.standard_normal((5, 8, 8)).astype(np.float32)
    table[3:, :, EOS] += 3.0  # rows finish at different steps
    enc = rng.standard_normal((4, 6, 8)).astype(np.float32)
    lens = np.ones(4, np.float32)
    kw = dict(bos_index=BOS, eos_index=EOS, min_decode_ratio=0.0,
              max_decode_ratio=1.5)
    ref = _JaxTableGreedy(table, **kw)(jnp.asarray(enc), jnp.asarray(lens))
    s = _TableGreedy(table, device="cpu", **kw)
    out = s(_t(enc), _t(lens))
    _same_greedy(out, ref)
    assert any(length < 9 for length in out[1])
    assert s.last_steps <= 9


@pytest.fixture(scope="module")
def decode_fns():
    """Log-prob functions over the transformer family's decoder on both
    sides, an eos bias in the logits so that hypotheses end at different
    steps."""
    jnet, v, net, src, tok, lens, jenc = _asr("transformer")
    head = JaxLinear(n_neurons=V)
    v_head = _params(head, jenc, seed=5)
    seq_lin = load(Linear(V, 16, device="cpu"), _np_tree(v_head))
    eos_bias = np.zeros(V, np.float32)
    eos_bias[EOS] = 1.0

    def j_logp(out):
        return jax.nn.log_softmax(head.apply(v_head, out) + eos_bias, -1)

    def t_logp(out):
        return torch.log_softmax(seq_lin(out) + _t(eos_bias), -1)

    j = dict(
        buf=lambda b, e, l: (j_logp(jnet.apply(v, b, e, l,
                                               method="decode")[0]), None),
        step=lambda t, c, e, l, s, a=None: (lambda o: (
            j_logp(o[0]), o[1], o[2]))(jnet.apply(
                v, t, e, c, s, l, anc=a, method="decode_step")),
        cache=lambda n, e, l: jnet.apply(v, n, 7, method="init_decoder_cache"),
    )
    p = dict(
        buf=lambda b, e, l: (t_logp(net.decode(b, e, l)[0]), None),
        step=lambda t, c, e, l, s, a=None: (lambda o: (
            t_logp(o[0]), o[1], o[2]))(net.decode_step(t, e, c, s, l,
                                                       anc=a)),
        cache=lambda n, e, l: net.init_decoder_cache(n, 7),
    )
    with torch.no_grad():
        enc = net.encode(_t(src), _t(lens))
    return j, p, jenc, enc, lens


def test_kv_greedy_searcher(decode_fns):
    j, p, jenc, enc, lens = decode_fns
    kw = dict(bos_index=BOS, eos_index=EOS, min_decode_ratio=0.0,
              max_decode_ratio=0.5)
    ref = jseq.S2SKVGreedySearcher(j["step"], j["cache"], **kw)(
        jenc, jnp.asarray(lens))
    out = seq2seq.S2SKVGreedySearcher(p["step"], p["cache"], device="cpu",
                                      **kw)(enc, _t(lens))
    _same_greedy(out, ref)


def test_transformer_greedy_searcher(decode_fns):
    j, p, jenc, enc, lens = decode_fns
    kw = dict(bos_index=BOS, eos_index=EOS, min_decode_ratio=0.0,
              max_decode_ratio=0.5, max_length=7)
    ref = jseq.S2STransformerGreedySearcher(j["buf"], V, **kw)(
        jenc, jnp.asarray(lens))
    out = seq2seq.S2STransformerGreedySearcher(p["buf"], V, device="cpu",
                                               **kw)(enc, _t(lens))
    _same_greedy(out, ref)


def test_transformer_beam_searcher(decode_fns):
    j, p, jenc, enc, lens = decode_fns
    kw = dict(bos_index=BOS, eos_index=EOS, min_decode_ratio=0.0,
              max_decode_ratio=0.5, beam_size=3, max_length=7,
              using_eos_threshold=False, topk=2, return_topk=True)
    ref = jseq.S2STransformerBeamSearcher(j["buf"], **kw)(
        jenc, jnp.asarray(lens))
    out = seq2seq.S2STransformerBeamSearcher(p["buf"], device="cpu", **kw)(
        enc, _t(lens))
    assert out[0] == ref[0]
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[2], ref[2], atol=MODEL_ATOL)
    assert out[3][0] == ref[3][0]
    np.testing.assert_allclose(out[3][1], ref[3][1], atol=MODEL_ATOL)


# -- head dim 18 through the ancestry search ---------------------------------

# the d-144, 8-head configurations (hyperconformer_8M,
# hyperbranchformer_13M) scaled down to d 36 and 2 heads: head dim 18
HD18 = dict(
    batch=2, seconds=0.5, vocab=V, n_mels=20, fe_channels=(8, 4),
    d_model=36, nhead=2, enc_layers=1, dec_layers=2, d_ffn=32, kernel_size=5,
    lm=False, encoder_module="conformer", attention_type="hypermixing",
    normalize_before=False, lm_d_model=0, lm_nhead=0, lm_layers=0,
    lm_d_ffn=0, beam=4, lm_weight=0.0, ctc_weight=0.3, temperature=1.15,
    max_decode_ratio=1.0, bos=BOS, eos=EOS, blank=0, pad_multiple=8,
)


def test_head_dim_18_through_the_ancestry_search():
    C = HD18
    assert C["d_model"] // C["nhead"] == 18
    assert 18 not in beam_attention.KERNEL_HEAD_DIMS
    wavs = np.random.default_rng(0).standard_normal(
        (C["batch"], int(chip_smoke.SR * C["seconds"]))).astype(np.float32)
    lens = np.array([1.0, 0.8], np.float32)
    fbank = JaxFbank(n_mels=C["n_mels"])
    frontend = JaxFrontEnd(num_blocks=2, out_channels=C["fe_channels"],
                           kernel_sizes=(3, 3), strides=(2, 2))
    jnet = JaxASR(
        tgt_vocab=V, input_size=5 * C["fe_channels"][-1],
        d_model=C["d_model"], nhead=C["nhead"],
        num_encoder_layers=C["enc_layers"],
        num_decoder_layers=C["dec_layers"], d_ffn=C["d_ffn"],
        encoder_module=C["encoder_module"],
        attention_type=C["attention_type"], kernel_size=C["kernel_size"],
    )
    ctc_lin, seq_lin = JaxLinear(n_neurons=V), JaxLinear(n_neurons=V)
    feats = jax.eval_shape(fbank, jnp.asarray(wavs))
    v_fe = _params(frontend, feats, train=False, seed=2)
    sub = jax.eval_shape(
        lambda f: frontend.apply(v_fe, f, train=False), feats
    )
    sub = jax.ShapeDtypeStruct(
        (sub.shape[0], -(-sub.shape[1] // C["pad_multiple"])
         * C["pad_multiple"], sub.shape[2]), sub.dtype,
    )
    v = _params(jnet, sub, jnp.zeros((2, 3), jnp.int32))

    @jax.jit
    def encode(wavs, lens):
        feats = fbank(wavs)
        sub, lens_p = jax_pad_time(frontend.apply(v_fe, feats, train=False),
                                   lens, multiple=C["pad_multiple"])
        return jnet.apply(v, sub, wav_len=lens_p, method="encode"), lens_p

    jenc, lens_p = encode(jnp.asarray(wavs), jnp.asarray(lens))
    v_ctc, v_seq = _params(ctc_lin, jenc, seed=3), _params(ctc_lin, jenc, seed=4)
    max_steps = int(jenc.shape[1] * C["max_decode_ratio"])

    def step_fn(toks, cache, e, l, step, anc=None):
        out, cache, attn = jnet.apply(v, toks, e, cache, step, anc=anc,
                                      method="decode_step")
        logits = seq_lin.apply(v_seq, out)
        return jax.nn.log_softmax(logits / C["temperature"], -1), cache, attn

    ref = jseq.S2SKVBeamSearcher(
        step_fn,
        lambda n, e, l: jnet.apply(v, e, max_steps + 1, n,
                                   method="init_decoder_cache_with_cross"),
        shared_cross_kv=True, ancestry_kv=True, bos_index=BOS,
        eos_index=EOS, min_decode_ratio=0.0, max_decode_ratio=1.0,
        beam_size=C["beam"], using_eos_threshold=False,
        length_normalization=True, temperature=C["temperature"],
        scorer=jscorer.ScorerBuilder(
            weights={"ctc": C["ctc_weight"]},
            partial_scorers={"ctc": jscorer.CTCScorer(
                ctc_fn=lambda e: jax.nn.log_softmax(
                    ctc_lin.apply(v_ctc, e), -1),
                blank_index=0, eos_index=EOS)},
        ),
    )(jenc, lens_p)

    pipe = chip_smoke.Pipeline(C, device="cpu", dtype=torch.float32)
    assert pipe.lm is None
    for module, tree in ((pipe.frontend, v_fe), (pipe.net, v),
                         (pipe.ctc_lin, v_ctc), (pipe.seq_lin, v_seq)):
        load(module, _np_tree(tree))
    hyps, lengths, scores, _ = pipe.transcribe(_t(wavs), _t(lens))
    assert hyps == ref[0]
    np.testing.assert_array_equal(lengths, ref[1])
    np.testing.assert_allclose(scores, ref[2], atol=MODEL_ATOL)
    assert pipe.searcher.last_steps >= 1


# -- remat -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["conformer_rope", "transformer",
                                  "hyperbranchformer"])
def test_encoder_remat_keeps_loss_and_gradients(name):
    """At dropout 0.1 in training mode: the recomputation in the backward
    pass draws the same dropout masks, so the loss and every gradient equal
    those of the run that keeps its activations."""
    kw = dict(_asr_kw(name), dropout=0.1)
    src = _t(_x((2, 12, 20)))
    tok = torch.randint(0, V, (2, 5), generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([1.0, 0.75])
    nets = [TransformerASR(**kw, encoder_remat=r, device="cpu",
                           generator=torch.Generator().manual_seed(1))
            for r in (False, True)]
    w_enc, w_dec = _t(_x((2, 12, 16), seed=5)), _t(_x((2, 5, 16), seed=6))

    def objective(enc, dec):
        return (enc * w_enc).sum() + (dec * w_dec).sum()

    runs = []
    for net in nets:
        net.train()
        torch.manual_seed(3)
        loss = objective(*net(src, tok, lens))
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     net.named_parameters()}))
    assert nets[1].encoder.remat and not nets[0].encoder.remat
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-6, atol=0)
    assert runs[0][1].keys() == runs[1][1].keys()
    for n, g in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][n], g, rtol=1e-5, atol=1e-7,
                                   msg=n)
    # dropout did act: an eval forward differs from the training one
    with torch.no_grad():
        nets[0].eval()
        assert not torch.allclose(objective(*nets[0](src, tok, lens)),
                                  runs[0][0])

