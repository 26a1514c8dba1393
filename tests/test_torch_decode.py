"""The serving slice as a whole against the JAX package, at a small size:
waveform -> Fbank -> front end -> Conformer encoder -> KV beam search fused
with a KV-cached TransformerLM and a CTC prefix scorer, with ancestry
decoding on and off. The port's stack is the assembly that
``chip_smoke.py`` drives on the GPU (``chip_smoke.Pipeline``), here on the
CPU with the kernels' plain versions; the JAX stack is assembled as in
``tests/unittests/test_ancestry_fused_decode.py``. Weights go from flax's
init through ``utils/jax_bridge``; the waveform comes from numpy.

Tolerances: 1e-4 on log-probs and hypothesis scores (float32 on both sides,
a few layers deep, sums in another order; the JAX prefix scorer also reads
its posteriors through a bf16 hi/lo split that keeps about 16 bits of
mantissa). Hypotheses must be equal token for token."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from speechbrain_tpu.decoders import scorer as jscorer
from speechbrain_tpu.decoders.ctc import CTCPrefixScore as JaxCTCPrefixScore
from speechbrain_tpu.decoders.seq2seq import (
    S2SBeamSearcher as JaxBeamSearcher,
    S2SKVBeamSearcher as JaxKVBeamSearcher,
)
from speechbrain_tpu.lobes.features import Fbank as JaxFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JaxFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JaxASR,
)
from speechbrain_tpu.lobes.models.transformer.TransformerLM import (
    TransformerLM as JaxLM,
)
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.utils.data_utils import (
    pad_time_to_multiple as jax_pad_time,
)
from speechbrain_tpu_torch.decoders.ctc import CTCPrefixScore
from speechbrain_tpu_torch.decoders.scorer import CTCScorer
from speechbrain_tpu_torch.decoders.seq2seq import (
    S2SBeamSearcher,
    S2SKVBeamSearcher,
)
from speechbrain_tpu_torch.decoders.utils import top_k_lowest_index
from speechbrain_tpu_torch.utils.jax_bridge import load

ATOL = 1e-4

# chip_smoke.NORTH cut to a size the CPU runs in seconds; same keys
SMALL = dict(
    batch=2, seconds=0.5, vocab=24, n_mels=20, fe_channels=(8, 4),
    d_model=16, nhead=4, enc_layers=1, dec_layers=2, d_ffn=32, kernel_size=5,
    lm_d_model=16, lm_nhead=4, lm_layers=2, lm_d_ffn=32, beam=5,
    lm_weight=0.6, ctc_weight=0.4, temperature=1.15, max_decode_ratio=1.0,
    bos=1, eos=2, blank=0, pad_multiple=8,
)


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxStack:
    """The JAX package's serving stack at the SMALL configuration."""

    def __init__(self, C):
        self.C = C
        keys = jax.random.split(jax.random.PRNGKey(0), 5)
        self.wavs = np.random.default_rng(0).standard_normal(
            (C["batch"], int(chip_smoke.SR * C["seconds"]))
        ).astype(np.float32)
        self.lens = np.array([1.0, 0.8], np.float32)
        self.fbank = JaxFbank(n_mels=C["n_mels"])
        self.frontend = JaxFrontEnd(
            num_blocks=2, out_channels=C["fe_channels"], kernel_sizes=(3, 3),
            strides=(2, 2),
        )
        self.net = JaxASR(
            tgt_vocab=C["vocab"], input_size=5 * C["fe_channels"][-1],
            d_model=C["d_model"], nhead=C["nhead"],
            num_encoder_layers=C["enc_layers"],
            num_decoder_layers=C["dec_layers"], d_ffn=C["d_ffn"],
            encoder_module="conformer", attention_type="RelPosMHAXL",
            kernel_size=C["kernel_size"], normalize_before=True,
        )
        self.ctc_lin = JaxLinear(n_neurons=C["vocab"])
        self.seq_lin = JaxLinear(n_neurons=C["vocab"])
        self.lm = JaxLM(
            vocab=C["vocab"], d_model=C["lm_d_model"], nhead=C["lm_nhead"],
            num_encoder_layers=C["lm_layers"], d_ffn=C["lm_d_ffn"],
            dropout=0.0, activation="gelu", normalize_before=False,
        )
        feats = self.fbank(jnp.asarray(self.wavs))
        self.v_fe = self.frontend.init(keys[0], feats, train=False)
        sub = self.frontend.apply(self.v_fe, feats, train=False)
        sub, self.lens_p = jax_pad_time(
            sub, jnp.asarray(self.lens), multiple=C["pad_multiple"]
        )
        tok0 = jnp.zeros((C["batch"], 3), jnp.int32)
        self.v = self.net.init(keys[1], sub, tok0)
        self.enc = self.net.apply(
            self.v, sub, wav_len=self.lens_p, method="encode"
        )
        self.v_ctc = self.ctc_lin.init(keys[2], self.enc)
        self.v_seq = self.seq_lin.init(keys[3], self.enc)
        self.v_lm = self.lm.init(keys[4], tok0)
        self.max_steps = max(
            1, int(self.enc.shape[1] * C["max_decode_ratio"])
        )

    def decode_step_fn(self, toks, cache, enc_states, enc_lens, step,
                       anc=None):
        out, cache, attn = self.net.apply(
            self.v, toks, enc_states, cache, step, anc=anc,
            method="decode_step",
        )
        logits = self.seq_lin.apply(self.v_seq, out)
        return (
            jax.nn.log_softmax(logits / self.C["temperature"], -1), cache,
            attn,
        )

    def ctc_fn(self, enc):
        return jax.nn.log_softmax(self.ctc_lin.apply(self.v_ctc, enc), -1)

    def searcher(self, ancestry):
        C = self.C
        scorers = jscorer.ScorerBuilder(
            weights={"ctc": C["ctc_weight"],
                     "transformerlm": C["lm_weight"]},
            full_scorers={
                "transformerlm": jscorer.KVTransformerLMScorer(
                    step_fn=lambda t, c, s, a=None: self.lm.apply(
                        self.v_lm, t, c, s, anc=a, method="score_step"
                    ),
                    init_cache_fn=lambda n, L: self.lm.apply(
                        self.v_lm, n, L, method="init_cache"
                    ),
                    max_length=self.max_steps + 1,
                    temperature=C["temperature"], ancestry=ancestry,
                )
            },
            partial_scorers={
                "ctc": jscorer.CTCScorer(
                    ctc_fn=self.ctc_fn, blank_index=C["blank"],
                    eos_index=C["eos"],
                )
            },
        )
        return JaxKVBeamSearcher(
            self.decode_step_fn,
            lambda n, e, l: self.net.apply(
                self.v, e, self.max_steps + 1, n,
                method="init_decoder_cache_with_cross",
            ),
            shared_cross_kv=True, ancestry_kv=ancestry, bos_index=C["bos"],
            eos_index=C["eos"], min_decode_ratio=0.0,
            max_decode_ratio=C["max_decode_ratio"], beam_size=C["beam"],
            using_eos_threshold=False, length_normalization=True,
            temperature=C["temperature"], scorer=scorers,
        )

    def port(self, ancestry):
        """The port's pipeline carrying this stack's weights."""
        pipe = chip_smoke.Pipeline(
            self.C, device="cpu", dtype=torch.float32, seed=0,
            ancestry=ancestry,
        )
        load(pipe.frontend, _np_tree(self.v_fe))
        load(pipe.net, _np_tree(self.v))
        load(pipe.ctc_lin, _np_tree(self.v_ctc))
        load(pipe.seq_lin, _np_tree(self.v_seq))
        load(pipe.lm, _np_tree(self.v_lm))
        return pipe


@pytest.fixture(scope="module")
def stack():
    return JaxStack(SMALL)


def test_encoder_half_of_the_slice(stack):
    pipe = stack.port(ancestry=True)
    enc, lens_p = pipe.encode(_t(stack.wavs), _t(stack.lens))
    assert enc.shape == stack.enc.shape
    np.testing.assert_allclose(lens_p.numpy(), stack.lens_p, atol=1e-7)
    np.testing.assert_allclose(enc.numpy(), stack.enc, atol=ATOL)


def test_forced_sequence_log_probs(stack):
    """One hypothesis per utterance, a forced token sequence: the decoder's
    and the LM's per-step log-probs (temperature included) agree."""
    C = stack.C
    pipe = stack.port(ancestry=False)
    tokens = np.random.default_rng(1).integers(
        3, C["vocab"], (C["batch"], 6)
    ).astype(np.int32)
    tokens[:, 0] = C["bos"]
    enc_t, lens_t = _t(stack.enc), _t(stack.lens_p)
    searcher = pipe._build_searcher(stack.max_steps)
    lm_scorer = searcher.scorer.full_scorers["transformerlm"]
    jlm_scorer = stack.searcher(False).scorer.full_scorers["transformerlm"]
    with torch.no_grad():
        cache = searcher.init_cache_fn(C["batch"], enc_t, lens_t)
        lm_mem = lm_scorer.reset_mem(enc_t, lens_t)
        jcache = stack.net.apply(
            stack.v, stack.enc, stack.max_steps + 1, C["batch"],
            method="init_decoder_cache_with_cross",
        )
        jlm_mem = jlm_scorer.reset_mem(stack.enc, stack.lens_p)
        for step in range(tokens.shape[1]):
            tok = tokens[:, step]
            ref, jcache, _ = stack.decode_step_fn(
                jnp.asarray(tok), jcache, stack.enc, stack.lens_p, step
            )
            out, cache, _ = searcher.decode_step_fn(
                _t(tok), cache, enc_t, lens_t, step
            )
            np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
            ref_lm, jlm_mem = jlm_scorer.score(
                jnp.asarray(tok), jlm_mem, None, None
            )
            out_lm, lm_mem = lm_scorer.score(_t(tok), lm_mem, None, None)
            np.testing.assert_allclose(out_lm.numpy(), ref_lm, atol=ATOL)


def test_ctc_prefix_score_one_step():
    rng = np.random.default_rng(2)
    B, T, V, beam, n_cand = 2, 9, 12, 3, 4
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    x = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    lens = np.array([1.0, 0.6], np.float32)
    n_bh = B * beam
    cands = np.stack(
        [rng.permutation(V)[:n_cand] for _ in range(n_bh)]
    ).astype(np.int32)
    cands[0, 0] = 2  # the eos candidate takes the full-sequence score
    last = rng.integers(1, V, (n_bh,)).astype(np.int32)
    ref_impl = JaxCTCPrefixScore(jnp.asarray(x), jnp.asarray(lens), 0, 2)
    impl = CTCPrefixScore(_t(x), _t(lens), 0, 2)
    ref_state = ref_impl.init_state(n_bh)
    state = impl.init_state(n_bh)
    for key in ("r_b", "r_n", "psi_prev"):
        np.testing.assert_allclose(
            state[key].numpy(), ref_state[key], atol=1e-5
        )
    for first in (True, False):
        is_first = np.full((n_bh,), first)
        ref_scores, ref_new = ref_impl.forward_step(
            jnp.asarray(is_first), jnp.asarray(last), jnp.asarray(cands),
            ref_state,
        )
        scores, new = impl.forward_step(
            _t(is_first), _t(last), _t(cands), state
        )
        np.testing.assert_allclose(scores.numpy(), ref_scores, atol=ATOL)
        # forward variables within each utterance's length; past it both
        # sides hold values that no consumer reads
        for b in range(n_bh):
            n = int(round(float(lens[b // beam]) * T))
            for key in ("r_b", "r_n"):
                np.testing.assert_allclose(
                    new[key][b, :n].numpy(), np.asarray(ref_new[key])[b, :n],
                    atol=ATOL, rtol=1e-5,
                )
        # carry the first candidate of every hypothesis into a second step
        pick = np.zeros((n_bh,), np.int64)
        hyp = np.arange(n_bh)
        ref_state = ref_impl.select_state(
            ref_new, jnp.asarray(hyp), jnp.asarray(pick)
        )
        state = impl.select_state(new, _t(hyp), _t(pick))
        last = cands[:, 0]


def test_ctc_scorer_selects_by_indexing_like_the_one_hot_product(stack):
    """CTCScorer.score + permute_and_select against the JAX scorer, with
    the beam layout set so that JAX takes its block-diagonal one-hot arm;
    one chosen token lies outside the candidates."""
    C = stack.C
    B, K, n_cand = C["batch"], 3, 4
    n_bh = B * K
    rng = np.random.default_rng(3)
    ref_sc = jscorer.CTCScorer(stack.ctc_fn, C["blank"], C["eos"])
    ref_sc._beam_layout = (B, K)
    pipe = stack.port(ancestry=True)
    sc = CTCScorer(
        lambda e: torch.log_softmax(pipe.ctc_lin(e), -1), C["blank"],
        C["eos"],
    )
    ref_mem = ref_sc.reset_mem(stack.enc, stack.lens_p, n_bh=n_bh)
    with torch.no_grad():
        mem = sc.reset_mem(_t(stack.enc), _t(stack.lens_p), n_bh=n_bh)
        tokens = np.full((n_bh,), C["bos"], np.int32)
        for _ in range(2):
            cands = np.stack(
                [rng.permutation(C["vocab"])[:n_cand] for _ in range(n_bh)]
            ).astype(np.int32)
            ref_scores, ref_new = ref_sc.score(
                jnp.asarray(tokens), ref_mem, jnp.asarray(cands), None
            )
            scores, new = sc.score(_t(tokens), mem, _t(cands), None)
            np.testing.assert_allclose(scores.numpy(), ref_scores, atol=ATOL)
            hyp = (
                rng.integers(0, K, (B, K)) + np.arange(B)[:, None] * K
            ).reshape(-1)
            chosen = cands[hyp, rng.integers(0, n_cand, n_bh)]
            missing = [t for t in range(3, C["vocab"])
                       if t not in cands[hyp[0]]]
            chosen[0] = missing[0]
            ref_mem = ref_sc.permute_and_select(
                ref_new, jnp.asarray(hyp), jnp.asarray(chosen)
            )
            mem = sc.permute_and_select(new, _t(hyp), _t(chosen))
            assert float(mem["psi_prev"][0]) == np.float32(
                CTCScorer.CTC_MINUS_INF
            )
            for key in ("r_b", "r_n", "psi_prev"):
                got, want = mem[key].numpy(), np.asarray(ref_mem[key])
                live = want > -1e19  # both hold -1e20 where blocked
                np.testing.assert_array_equal(got > -1e19, live)
                np.testing.assert_allclose(
                    got[live], want[live], atol=ATOL, rtol=1e-5
                )
            tokens = chosen.astype(np.int32)


@pytest.mark.parametrize("ancestry", [True, False], ids=["ancestry", "permute"])
def test_transcribe_matches_jax_token_for_token(stack, ancestry):
    hyps, lengths, scores, _ = stack.searcher(ancestry)(
        stack.enc, stack.lens_p
    )
    pipe = stack.port(ancestry)
    out_hyps, out_lengths, out_scores, _ = pipe.transcribe(
        _t(stack.wavs), _t(stack.lens)
    )
    assert out_hyps == hyps
    np.testing.assert_array_equal(out_lengths, lengths)
    np.testing.assert_allclose(out_scores, scores, atol=ATOL)
    assert all(len(h) > 0 for h in out_hyps)
    # the loop left early, once every beam had finished
    assert 0 < pipe.searcher.last_steps <= stack.max_steps
    assert pipe.fbank_calls == 1


SEARCH_OPTIONS = {
    "eos_threshold": dict(using_eos_threshold=True, eos_threshold=1.2),
    "attn_shift_topk": dict(
        using_eos_threshold=False, using_max_attn_shift=True,
        max_attn_shift=2, topk=3, return_topk=True,
    ),
    "length_reward_min_steps": dict(
        using_eos_threshold=False, length_normalization=False,
        length_rewarding=0.3, min_decode_ratio=0.25,
    ),
}


@pytest.mark.parametrize("name", sorted(SEARCH_OPTIONS))
def test_searcher_without_scorer_matches_jax(stack, name):
    """The bare KV searcher (no LM, no CTC) under its other options."""
    C = stack.C
    pipe = stack.port(ancestry=True)
    kw = dict(
        shared_cross_kv=True, ancestry_kv=True, bos_index=C["bos"],
        eos_index=C["eos"], min_decode_ratio=0.0, max_decode_ratio=1.0,
        beam_size=4,
    )
    kw.update(SEARCH_OPTIONS[name])
    ref = JaxKVBeamSearcher(
        stack.decode_step_fn,
        lambda n, e, l: stack.net.apply(
            stack.v, e, stack.max_steps + 1, n,
            method="init_decoder_cache_with_cross",
        ),
        **kw,
    )(stack.enc, stack.lens_p)
    port_searcher = pipe._build_searcher(stack.max_steps)
    out = S2SKVBeamSearcher(
        port_searcher.decode_step_fn, port_searcher.init_cache_fn,
        device="cpu", **kw,
    )(_t(stack.enc), _t(stack.lens_p))
    assert out[0] == ref[0]
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[2], ref[2], atol=ATOL)
    if kw.get("return_topk"):
        assert out[3][0] == ref[3][0]
        np.testing.assert_allclose(out[3][1], ref[3][1], atol=ATOL)
    else:
        assert out[3] is None and ref[3] is None


def test_top_k_breaks_ties_like_jax():
    x = np.array(
        [[-1e20, 0.5, -1e20, 0.5, -1e20, 0.25, -1e20, -1e20],
         [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32,
    )
    for k in (1, 3, 6):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        v, i = top_k_lowest_index(_t(x), k)
        np.testing.assert_array_equal(i.numpy(), ref_i)
        np.testing.assert_array_equal(v.numpy(), ref_v)


def test_record_finished_keeps_slot_order_and_cap():
    K, L = 3, 4
    kw = dict(bos_index=1, eos_index=2, min_decode_ratio=0.0,
              max_decode_ratio=1.0, beam_size=K)
    ref_s = JaxBeamSearcher(**kw)
    s = S2SBeamSearcher(**kw, device="cpu")
    rng = np.random.default_rng(4)
    record = np.array([[True, False, True], [True, True, True]])
    scores = rng.standard_normal((2, K)).astype(np.float32)
    seq = rng.integers(0, 9, (2, K, L)).astype(np.int32)
    lens = np.full((2, K), 3, np.int32)
    fin = (
        np.zeros((2, K, L), np.int32),
        np.full((2, K), -1e20, np.float32),
        np.zeros((2, K), np.int32),
        np.array([2, 1], np.int32),  # already 2 and 1 finished
    )
    ref = ref_s._record_finished(
        jnp.asarray(record), jnp.asarray(scores), jnp.asarray(seq),
        jnp.asarray(lens), *map(jnp.asarray, fin),
    )
    out = s._record_finished(
        _t(record), _t(scores), _t(seq), _t(lens), *map(_t, fin)
    )
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert out[3].tolist() == [3, 3]
