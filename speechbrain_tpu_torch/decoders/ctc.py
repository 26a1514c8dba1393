"""CTC decoding (port of ``filter_ctc_output``, ``ctc_greedy_decode`` and
``CTCPrefixScore`` from ``speechbrain_tpu/decoders/ctc.py``): greedy
decoding, and batched prefix scoring over a pruned candidate set, used for
joint CTC/attention beam decoding.
"""

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
