"""CTC decoding (port of ``speechbrain_tpu/decoders/ctc.py``): greedy
decoding, batched prefix scoring over a pruned candidate set, used for
joint CTC/attention beam decoding, and the host-side CTC beam searchers
(``CTCBeam``, ``CTCBaseSearcher``, ``CTCBeamSearcher``,
``CTCPrefixBeamSearcher``) that give the n-best lists of second-pass
rescoring.
"""

import dataclasses

import numpy as np
import torch

from speechbrain_tpu_torch.decoders.utils import inflate_tensor
from speechbrain_tpu_torch.utils.data_utils import undo_padding

NEG_INF = -1e20


def filter_ctc_output(string_pred, blank_id=-1):
    """Merge repeats, then drop blanks.

    Example
    -------
    >>> filter_ctc_output([0, 1, 1, 0, 2, 2], blank_id=0)
    [1, 2]
    """
    if not isinstance(string_pred, list):
        raise ValueError("filter_ctc_output expects a list")
    out = [v for i, v in enumerate(string_pred)
           if i == 0 or v != string_pred[i - 1]]
    return [v for v in out if v != blank_id]


def ctc_greedy_decode(probabilities, seq_lens, blank_id=-1):
    """Greedy CTC: the argmax over classes, taken on the tensor's device;
    the ids move to the host once, are cut to each relative length,
    collapsed and stripped of blanks. A negative ``blank_id`` counts from
    the last class. Returns a list of Python lists.

    Example
    -------
    >>> probs = torch.tensor([[[0.1, 0.9], [0.9, 0.1]]])
    >>> ctc_greedy_decode(probs, torch.tensor([1.0]), blank_id=0)
    [[1]]
    """
    if isinstance(blank_id, int) and blank_id < 0:
        blank_id = probabilities.shape[-1] + blank_id
    argmaxes = probabilities.argmax(dim=-1)
    return [filter_ctc_output(seq, blank_id=blank_id)
            for seq in undo_padding(argmaxes, seq_lens)]


class CTCPrefixScore:
    """Batched CTC prefix scoring for joint CTC/attention decoding.

    For ``n_bh`` hypotheses and a pruned candidate set of size ``n_cand``
    per hypothesis, maintains the CTC forward variables r^n/r^b of each
    hypothesis over encoder time and returns the prefix log-probability of
    each (hypothesis + candidate) extension.

    Usage inside beam search:

    >>> # scorer = CTCPrefixScore(x, enc_lens, blank_index, eos_index)
    >>> # state = scorer.init_state(n_bh)
    >>> # scores, new_state = scorer.forward_step(first, last, cands, state)
    """

    def __init__(self, x, enc_lens, blank_index, eos_index,
                 ctc_window_size=0):
        # x: (B, T, V) log-probs from the CTC head
        self.x = x
        self.B, self.T, self.V = x.shape
        self.enc_lens = torch.round(enc_lens * self.T).to(torch.int64)
        self.blank_index = blank_index
        self.eos_index = eos_index
        self.time_mask = (
            torch.arange(self.T, device=x.device)[None, :]
            < self.enc_lens[:, None]
        )  # (B, T)

    def init_state(self, n_bh):
        """Initial forward variables for empty prefixes, per hypothesis.

        r_b[t] = sum of blank-path scores of the empty prefix up to t;
        r_n = -inf (empty prefix can't end in non-blank).
        """
        beam = n_bh // self.B
        x_blank = self.x[:, :, self.blank_index]  # (B, T)
        x_blank = torch.where(self.time_mask, x_blank, 0.0)
        r_b = torch.cumsum(x_blank, dim=1)  # (B, T)
        r_b = inflate_tensor(r_b, beam, dim=0)  # (n_bh, T)
        r_n = torch.full_like(r_b, NEG_INF)
        psi_prev = r_b.new_zeros((n_bh,))  # log P_ctc(g) of current prefixes
        return {"r_b": r_b, "r_n": r_n, "psi_prev": psi_prev}

    def forward_step(self, inp_is_first, last_tokens, cands, state):
        """Score candidate extensions.

        Arguments
        ---------
        inp_is_first : bool tensor (n_bh,)
            True while the prefix is empty (only bos consumed).
        last_tokens : int tensor (n_bh,)
            Last non-bos token of each prefix (ignored when first).
        cands : int tensor (n_bh, n_cand)
            Candidate next tokens to score.
        state : dict from init_state / previous select.

        Returns
        -------
        scores : (n_bh, n_cand) — log P_ctc(g+c) - log P_ctc(g)
        new_states : dict of (n_bh, T, n_cand) forward variables per
            candidate; select with ``select_state`` after pruning.
        """
        n_bh, n_cand = cands.shape
        beam = n_bh // self.B
        T = self.T
        r_b_prev = state["r_b"]  # (n_bh, T)
        r_n_prev = state["r_n"]
        cands = cands.long()
        # per-candidate emission scores x_c (n_bh, T, n_cand): a gather
        # along the vocab axis of the (B, T, V) posteriors, grouped by
        # utterance so that no beam-replicated copy of them is made (the
        # JAX package contracts with a one-hot matrix instead; the
        # selection is the same)
        idx = cands.reshape(self.B, 1, beam * n_cand).expand(-1, T, -1)
        x_c = torch.gather(self.x, 2, idx)  # (B, T, beam*n_cand)
        x_c = x_c.reshape(self.B, T, beam, n_cand).permute(0, 2, 1, 3)
        x_c = x_c.reshape(n_bh, T, n_cand)
        x_blank = inflate_tensor(
            self.x[:, :, self.blank_index], beam, dim=0
        )  # (n_bh, T)
        # phi[t] = r_b_prev[t] + (r_n_prev[t] unless cand == last token)
        same_as_last = cands == last_tokens[:, None]  # (n_bh, n_cand)
        phi = torch.logaddexp(
            r_b_prev[:, :, None],
            torch.where(
                same_as_last[:, None, :], NEG_INF, r_n_prev[:, :, None]
            ),
        )  # (n_bh, T, n_cand)

        time_mask = inflate_tensor(self.time_mask, beam, dim=0)

        # The per-frame recurrences
        #   r_n[t] = (r_n[t-1] (+) phi[t-1]) (*) x_c[t]
        #   r_b[t] = (r_n[t-1] (+) r_b[t-1]) (*) x_blank[t]
        # are first-order LINEAR in the log semiring with known inputs, so
        # both have closed forms
        #   r[t] = X[t] (+)-sum_{s<=t} ( input[s] - X[s-1] ),
        # i.e. a cumsum of per-frame self-coefficients plus one
        # logcumsumexp — no serial scan over time.
        #
        # Masked frames use a MODERATE negative (not -1e9) inside the
        # cumsums so the subtracted prefix sums stay in fp32 range; the
        # affected entries only ever land beyond enc_len, where no
        # downstream consumer reads them.
        MASK = -1e4
        valid = time_mask[:, :, None]  # (n_bh, T, 1)
        first = torch.where(inp_is_first[:, None], 0.0, NEG_INF)
        # phi[t-1], with the start injection r_n[0] = x_c[0] at t = 0
        phi_in = torch.cat(
            [first[:, None, :].expand(n_bh, 1, n_cand), phi[:, : T - 1]],
            dim=1,
        )
        xc_m = torch.where(valid, x_c, MASK)
        Xc = torch.cumsum(xc_m, dim=1)
        Xc_prev = torch.cat(
            [Xc.new_zeros((n_bh, 1, n_cand)), Xc[:, : T - 1]], dim=1
        )
        r_n_seq = Xc + torch.logcumsumexp(phi_in - Xc_prev, dim=1)

        xb_m = torch.where(time_mask, x_blank, 0.0)[:, :, None]
        Xb = torch.cumsum(xb_m, dim=1)
        Xb_prev = torch.cat(
            [Xb.new_zeros((n_bh, 1, 1)), Xb[:, : T - 1]], dim=1
        )
        rn_prev_in = torch.cat(
            [r_n_seq.new_full((n_bh, 1, n_cand), NEG_INF),
             r_n_seq[:, : T - 1]],
            dim=1,
        )
        rn_prev_in = torch.where(valid, rn_prev_in, NEG_INF)
        r_b_seq = Xb + torch.logcumsumexp(rn_prev_in - Xb_prev, dim=1)

        # psi needs no recursion: sum over frames of phi[t-1] (*) x_c[t]
        # (+ the start injection of x_c[0])
        psi_terms = torch.where(valid, phi_in + x_c, NEG_INF)
        psi = torch.logsumexp(psi_terms, dim=1)  # (n_bh, n_cand)
        start_term = torch.where(
            inp_is_first[:, None] & time_mask[:, 0][:, None],
            x_c[:, 0], NEG_INF,
        )
        psi = torch.logaddexp(psi, start_term)
        # eos candidate: score is the full-sequence probability of g
        last = (inflate_tensor(self.enc_lens, beam, dim=0) - 1)[:, None]
        psi_full = torch.logaddexp(
            state["r_b"].gather(1, last), state["r_n"].gather(1, last)
        )  # (n_bh, 1)
        psi = torch.where(cands == self.eos_index, psi_full, psi)
        scores = psi - state["psi_prev"][:, None]
        new_states = {"r_b": r_b_seq, "r_n": r_n_seq, "psi": psi}
        return scores, new_states

    def select_state(self, new_states, hyp_indices, cand_indices):
        """After topk pruning: keep one candidate's forward variables per
        surviving hypothesis. hyp_indices/cand_indices: (n_bh,)"""
        r_b = new_states["r_b"][hyp_indices, :, cand_indices]  # (n_bh, T)
        r_n = new_states["r_n"][hyp_indices, :, cand_indices]
        psi = new_states["psi"][hyp_indices, cand_indices]
        return {"r_b": r_b, "r_n": r_n, "psi_prev": psi}


# ---------------------------------------------------------------------------
# Host-side CTC beam search (pyctcdecode-style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CTCBeam:
    """One beam of the host-side CTC search: its token tuple, last token,
    the log-probabilities of its paths that end in blank and in a token,
    its score and the LM state."""

    text: tuple
    last_token: int
    p_blank: float
    p_non_blank: float
    score: float
    lm_state: object = None

    @property
    def p_total(self):
        return np.logaddexp(self.p_blank, self.p_non_blank)


def _logsumexp(*xs):
    return float(np.logaddexp.reduce(np.asarray(xs)))


def _host(x):
    """A tensor (on any device, of any float type) or an array as a numpy
    array: float tensors come over as float32, in one copy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class CTCBaseSearcher:
    """The host-side searchers' settings and batch loop.

    ``__call__(log_probs, wav_lens=None)`` copies the ``(B, T, V)``
    log-probabilities to the host once, cuts utterance ``b`` to
    ``round(wav_lens[b] * T)`` frames and returns, for each, its best
    ``topk`` beams (:class:`CTCBeam`), best first. The search runs in numpy
    and Python floats, one utterance at a time.

    ``lm`` is an object with ``score_tokens(token tuple) -> log-prob`` (or
    kenlm's ``score(sentence)`` with ``vocab_list``); a hypothesis' score
    is then its CTC log-probability + ``alpha * lm`` + ``beta * length``.
    ``kenlm_model_path`` loads a kenlm model, and raises ``ImportError``
    where the ``kenlm`` package is missing.
    """

    def __init__(self, blank_index, vocab_list=None, space_token=" ",
                 kenlm_model_path=None, beam_size=100, beam_prune_logp=-10.0,
                 token_prune_min_logp=-5.0, prune_history=True, topk=1,
                 alpha=0.5, beta=1.5, lm=None):
        self.blank_index = blank_index
        self.vocab_list = vocab_list
        self.beam_size = beam_size
        self.beam_prune_logp = beam_prune_logp
        self.token_prune_min_logp = token_prune_min_logp
        self.prune_history = prune_history
        self.topk = topk
        self.alpha = alpha
        self.beta = beta
        self.lm = lm
        if kenlm_model_path is not None and lm is None:
            try:
                import kenlm  # pragma: no cover

                self.lm = kenlm.Model(kenlm_model_path)
            except ImportError:
                raise ImportError("kenlm not available; pass lm= instead")

    def __call__(self, log_probs, wav_lens=None):
        log_probs = _host(log_probs)
        B, T, V = log_probs.shape
        if wav_lens is None:
            lens = [T] * B
        else:
            lens = [int(round(float(v) * T)) for v in _host(wav_lens)]
        return [self.search(log_probs[b, : lens[b]])[: self.topk]
                for b in range(B)]

    def search(self, log_probs):
        raise NotImplementedError


class CTCBeamSearcher(CTCBaseSearcher):
    """CTC prefix beam search with optional shallow LM scoring.

    Each frame extends every beam by the tokens whose log-probability
    reaches ``token_prune_min_logp`` (in vocabulary order; the frame's
    argmax where none does): blank keeps the text, a repeat of the last
    token keeps it on the non-blank paths and extends it after a blank,
    any other token extends it. Beams with the same text merge (in the
    order they arise; the first LM state is kept). Then the beams are
    scored, sorted by score (a stable sort) and the best ``beam_size``
    kept, less those more than ``-beam_prune_logp`` below the best.

    Example
    -------
    >>> lp = np.log(np.asarray([[[0.05, 0.05, 0.9], [0.05, 0.9, 0.05]]]))
    >>> searcher = CTCBeamSearcher(blank_index=0, beam_size=4)
    >>> tuple(int(t) for t in searcher(lp)[0][0].text)
    (2, 1)
    """

    def search(self, log_probs):
        T, V = log_probs.shape
        beams = {(): CTCBeam((), -1, 0.0, NEG_INF, 0.0)}
        for t in range(T):
            frame = log_probs[t]
            candidates = np.where(frame >= self.token_prune_min_logp)[0]
            if len(candidates) == 0:
                candidates = [int(np.argmax(frame))]
            next_beams = {}

            def upd(text, last, pb, pnb, lm_state=None):
                prev = next_beams.get(text)
                if prev is None:
                    next_beams[text] = CTCBeam(text, last, pb, pnb, 0.0,
                                               lm_state)
                else:
                    next_beams[text] = CTCBeam(
                        text, last, np.logaddexp(prev.p_blank, pb),
                        np.logaddexp(prev.p_non_blank, pnb), 0.0,
                        prev.lm_state or lm_state)

            for beam in beams.values():
                p_tot = beam.p_total
                for c in candidates:
                    p = float(frame[c])
                    if c == self.blank_index:
                        upd(beam.text, beam.last_token, p_tot + p, NEG_INF,
                            beam.lm_state)
                    elif c == beam.last_token:
                        # the repeat merges into the same text on the
                        # non-blank paths, and after a blank extends it
                        upd(beam.text, c, NEG_INF, beam.p_non_blank + p,
                            beam.lm_state)
                        upd(beam.text + (c,), c, NEG_INF, beam.p_blank + p,
                            beam.lm_state)
                    else:
                        upd(beam.text + (c,), c, NEG_INF, p_tot + p,
                            beam.lm_state)
            scored = []
            for beam in next_beams.values():
                score = beam.p_total
                if self.lm is not None and len(beam.text):
                    score = (score + self.alpha * self.lm_score(beam.text)
                             + self.beta * len(beam.text))
                scored.append(dataclasses.replace(beam, score=score))
            scored.sort(key=lambda b: b.score, reverse=True)
            best = scored[0].score if scored else 0.0
            beams = {b.text: b for b in scored[: self.beam_size]
                     if b.score >= best + self.beam_prune_logp}
        return sorted(beams.values(), key=lambda b: b.score, reverse=True)

    def lm_score(self, text):
        """The LM's log-probability of a token tuple: ``lm.score_tokens``
        where the LM has it, else kenlm's ``score`` of the text spelled
        with ``vocab_list`` (``_`` read as a space), else 0."""
        if hasattr(self.lm, "score_tokens"):
            return self.lm.score_tokens(text)
        if self.vocab_list is not None and hasattr(self.lm, "score"):
            sentence = "".join(self.vocab_list[t] for t in text).replace(
                "_", " ")
            return self.lm.score(sentence)
        return 0.0


class CTCPrefixBeamSearcher(CTCBeamSearcher):
    """The same prefix-merging search as :class:`CTCBeamSearcher`, under
    the name recipes configure."""
