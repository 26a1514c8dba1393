"""How far the port's CTC prefix scores are from the JAX package's at a
decode's full width (``ROADMAP.md`` C6). The JAX ``CTCPrefixScore`` reads
its posteriors through a bfloat16 hi/lo split (about 16 bits of
mantissa, made for the TPU's matrix unit); the port gathers them exactly.

    JAX_PLATFORMS=cpu python3 tools/c6_ctc_precision.py

Vocabulary 5000, 256 encoder frames, beam 10, 2 utterances (the second
at 0.75 of the frames); posteriors from numpy (random logits with the
blank raised on 70 % of the frames, so that CTC's paths are peaked as a
trained head's are), handed to both packages:

1. ``prefix_scores``: both packages' ``CTCPrefixScore`` stepped along the
   same token path (one hypothesis an utterance, 40 steps; the path's
   token and 199 random candidates scored each step, state carried by
   the path's token): the largest difference of the scores over all
   steps and candidates, absolute and relative to the score;
2. ``search``: each package's ``S2SKVBeamSearcher`` (permuting mode) with
   its ``CTCScorer`` at weight 0.4 over a fixed "decoder" that gives each
   token's log-probabilities from a numpy table (so the CTC scorer is the
   only arithmetic that differs): are the best hypotheses equal, and how
   far apart are their scores.

CPU only; float32; prints one JSON object. Nothing is timed.
"""

import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from speechbrain_tpu.decoders.ctc import (  # noqa: E402
    CTCPrefixScore as JaxCTCPrefixScore,
)
from speechbrain_tpu.decoders.scorer import (  # noqa: E402
    CTCScorer as JaxCTCScorer,
    ScorerBuilder as JaxScorerBuilder,
)
from speechbrain_tpu.decoders.seq2seq import (  # noqa: E402
    S2SKVBeamSearcher as JaxKVBeamSearcher,
)
from speechbrain_tpu_torch.decoders.ctc import CTCPrefixScore  # noqa: E402
from speechbrain_tpu_torch.decoders.scorer import (  # noqa: E402
    CTCScorer,
    ScorerBuilder,
)
from speechbrain_tpu_torch.decoders.seq2seq import (  # noqa: E402
    S2SKVBeamSearcher,
)

V, T, BEAM, B = 5000, 256, 10, 2
BLANK, BOS, EOS = 0, 1, 2
CTC_WEIGHT = 0.4
MAX_DECODE_RATIO = 0.2


def posteriors(seed=0):
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.standard_normal((B, T, V)).astype(np.float32)
    blank_frames = rng.random((B, T)) < 0.7
    logits[..., BLANK] += np.where(blank_frames, 8.0, 0.0)
    x = logits - logits.max(-1, keepdims=True)
    x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x.astype(np.float32), np.array([1.0, 0.75], np.float32)


def prefix_scores(x, lens, steps=40, n_cand=200, seed=1):
    rng = np.random.default_rng(seed)
    jimpl = JaxCTCPrefixScore(jnp.asarray(x), jnp.asarray(lens), BLANK, EOS)
    impl = CTCPrefixScore(torch.from_numpy(x), torch.from_numpy(lens),
                          BLANK, EOS)
    jstate, state = jimpl.init_state(B), impl.init_state(B)
    last = np.full((B,), BOS, np.int32)
    path = rng.integers(3, V, (steps, B)).astype(np.int32)
    max_abs = max_rel = 0.0
    for step in range(steps):
        cands = np.stack([rng.choice(np.arange(3, V), n_cand, replace=False)
                          for _ in range(B)]).astype(np.int32)
        cands[:, 0] = path[step]
        first = np.full((B,), step == 0)
        jscores, jnew = jimpl.forward_step(
            jnp.asarray(first), jnp.asarray(last), jnp.asarray(cands),
            jstate)
        scores, new = impl.forward_step(
            torch.from_numpy(first), torch.from_numpy(last),
            torch.from_numpy(cands), state)
        a, b = scores.numpy(), np.asarray(jscores)
        live = b > -1e19
        diff = np.abs(a - b)[live]
        max_abs = max(max_abs, float(diff.max()))
        max_rel = max(max_rel, float((diff / np.abs(b[live])).max()))
        hyp, pick = np.arange(B), np.zeros((B,), np.int64)
        jstate = jimpl.select_state(jnew, jnp.asarray(hyp),
                                    jnp.asarray(pick))
        state = impl.select_state(new, torch.from_numpy(hyp),
                                  torch.from_numpy(pick))
        last = path[step]
    return {"steps": steps, "candidates_a_step": n_cand,
            "max_abs_diff": max_abs, "max_rel_diff": max_rel}


def search(x, lens, seed=2):
    table = np.random.default_rng(seed).standard_normal(
        (64, V)).astype(np.float32)
    table = table - np.log(np.exp(table).sum(-1, keepdims=True))
    enc = np.zeros((B, T, 8), np.float32)
    kw = dict(shared_cross_kv=True, ancestry_kv=False, bos_index=BOS,
              eos_index=EOS, min_decode_ratio=0.0,
              max_decode_ratio=MAX_DECODE_RATIO, beam_size=BEAM,
              using_eos_threshold=False, length_normalization=True)
    jtable, ttable = jnp.asarray(table), torch.from_numpy(table)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    def jstep(toks, cache, enc_states, enc_lens, step, anc=None):
        return jtable[toks % 64], cache, jnp.zeros((toks.shape[0], T))

    def tstep(toks, cache, enc_states, enc_lens, step, anc=None):
        return ttable[toks.long() % 64], cache, torch.zeros(toks.shape[0], T)

    jsearcher = JaxKVBeamSearcher(
        jstep, lambda n, e, l: [{"self": jnp.zeros((n, 1))}],
        scorer=JaxScorerBuilder(
            weights={"ctc": CTC_WEIGHT},
            partial_scorers={"ctc": JaxCTCScorer(
                ctc_fn=lambda e: jx, blank_index=BLANK, eos_index=EOS)}),
        **kw)
    searcher = S2SKVBeamSearcher(
        tstep, lambda n, e, l: [{"self": torch.zeros(n, 1)}],
        scorer=ScorerBuilder(
            weights={"ctc": CTC_WEIGHT},
            partial_scorers={"ctc": CTCScorer(
                ctc_fn=lambda e: tx, blank_index=BLANK, eos_index=EOS)}),
        device="cpu", **kw)
    jhyps, _, jscores, _ = jsearcher(jnp.asarray(enc), jnp.asarray(lens))
    with torch.no_grad():
        hyps, _, scores, _ = searcher(torch.from_numpy(enc),
                                      torch.from_numpy(lens))
    jhyps = [list(map(int, h)) for h in jhyps]
    return {"steps": searcher.last_steps, "best_hypotheses_equal":
            hyps == jhyps, "hyp_lengths": [len(h) for h in hyps],
            "max_score_diff": float(np.max(np.abs(
                np.asarray(scores) - np.asarray(jscores))))}


def main():
    x, lens = posteriors()
    print(json.dumps({
        "config": {"vocab": V, "frames": T, "beam": BEAM, "batch": B,
                   "lens": lens.tolist(), "ctc_weight": CTC_WEIGHT,
                   "max_decode_ratio": MAX_DECODE_RATIO,
                   "device": "cpu", "jax": jax.__version__,
                   "torch": torch.__version__},
        "prefix_scores": prefix_scores(x, lens),
        "search": search(x, lens),
    }))


if __name__ == "__main__":
    main()
