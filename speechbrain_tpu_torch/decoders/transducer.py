"""Transducer decoding (port of ``speechbrain_tpu/decoders/transducer.py``):
greedy on the device, beam search on the host.

Greedy is the JAX package's fixed-bound loop: at every encoder frame up to
``max_symbols_per_step`` labels, each inner step masked once a row has
emitted a blank, into an output buffer of ``T * max_symbols_per_step``
tokens per row. No value is read on the host inside the loop, so the
tokens do not depend on an early exit; the buffer is read once at the end.
The searcher takes no lengths: it decodes every frame of ``tn_output``,
padding included, as the JAX searcher does, so the caller chooses what it
hands over.

Beam search is the JAX package's host loop, one utterance at a time
(transducer beams are ragged), with its ranking (``logp_score`` over the
prediction's length), its pruning (``state_beam``, ``expand_beam``, the
top ``beam_size`` labels counting blank) and optional shallow fusion of a
language model.

The prediction network's state is a tensor or a tuple of tensors laid out
as the port's recurrent layers lay theirs out, ``(layers * directions,
batch, hidden)``: greedy masks the batch axis, ``HIDDEN_BATCH_AXIS``. The
JAX searcher guesses the axis from the shapes and masks the layer axis
where ``layers * directions`` equals the batch (ROADMAP.md C33).
"""

import dataclasses

import numpy as np
import torch

# the batch axis of the prediction network's state tensors
HIDDEN_BATCH_AXIS = 1


def _map(fn, *trees):
    """``fn`` over tensors or over tuples of tensors, leaf by leaf."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


@dataclasses.dataclass
class TransducerGreedySearcherStreamingContext:
    """Streaming state carried from one chunk to the next: the last
    emitted token of each row and the prediction network's state."""

    hidden: object = None
    last_token: object = None


class TransducerBeamSearcher:
    """Greedy (``beam_size`` 1) or beam transducer search.

    Arguments
    ---------
    decode_network_lst : callable
        ``pred_step(tokens (B, 1), hidden) -> (pn_out (B, 1, H), hidden)``,
        the prediction network's step (embedding, recurrence, projection);
        ``hidden`` None starts from zeros.
    tjoint : callable
        ``tjoint(enc (B, 1, 1, H), pn (B, 1, 1, H)) -> (B, 1, 1, J)``.
    classifier_network : callable
        The joint's output -> vocabulary logits.
    blank_id : int
    beam_size : int (1 = greedy)
    nbest : int
    lm_module : callable, optional
        ``lm(tokens (1, 1), hidden) -> (logits (1, 1, V), hidden)``.
    lm_weight : float
    state_beam, expand_beam : float
        The pruning constants.
    max_symbols_per_step : int

    Example
    -------
    >>> from speechbrain_tpu_torch.nnet.linear import Linear
    >>> emb = torch.nn.Embedding(5, 4)
    >>> def pred_step(tokens, hidden):
    ...     return emb(tokens), torch.zeros(1, tokens.shape[0], 4)
    >>> out = Linear(5, 4, device="cpu")
    >>> searcher = TransducerBeamSearcher(
    ...     pred_step, lambda e, p: torch.tanh(e + p), out, blank_id=0,
    ...     beam_size=1)
    >>> hyps, _, _, _ = searcher(torch.randn(2, 6, 4))
    >>> len(hyps)
    2
    """

    def __init__(self, decode_network_lst, tjoint, classifier_network,
                 blank_id, beam_size=4, nbest=5, lm_module=None,
                 lm_weight=0.0, state_beam=2.3, expand_beam=2.3,
                 max_symbols_per_step=10):
        self.pred_step = decode_network_lst
        self.tjoint = tjoint
        self.classifier = classifier_network
        self.blank_id = blank_id
        self.beam_size = beam_size
        self.nbest = nbest
        self.lm = lm_module
        self.lm_weight = lm_weight
        self.state_beam = state_beam
        self.expand_beam = expand_beam
        self.max_symbols_per_step = max_symbols_per_step

    def __call__(self, tn_output):
        """tn_output: (B, T, H) encoder states. Returns ``(hyps, scores,
        nbest hyps, nbest scores)`` (greedy: scores None)."""
        if self.beam_size == 1:
            return self.transducer_greedy_decode(tn_output)
        return self.transducer_beam_search_decode(tn_output)

    def _step_log_probs(self, enc_t, tokens, hidden):
        """One prediction-network step and the joint: (log-probabilities
        (B, V) in float32, the new hidden state)."""
        pn_out, hidden = self.pred_step(tokens, hidden)
        joint = self.tjoint(enc_t[:, :, None, :], pn_out[:, None, :, :])
        logits = self.classifier(joint)[:, 0, 0]
        return torch.log_softmax(logits.float(), dim=-1), hidden

    # -- greedy (on the device, batched) -----------------------------------
    @torch.no_grad()
    def transducer_greedy_decode(self, tn_output, hidden_state=None,
                                 return_hidden=False):
        """Batched greedy decode. For chunk-wise streaming, pass
        ``hidden_state=(last_token, hidden)`` from the previous chunk and
        ``return_hidden=True``."""
        tokens, carry = self._greedy(tn_output, hidden_state)
        hyps = [[t for t in row if t != self.blank_id]
                for row in tokens.tolist()]
        if return_hidden:
            return hyps, None, None, None, carry
        return hyps, None, None, None

    def transducer_greedy_decode_streaming(self, x, context):
        """One chunk of streaming greedy decode against a
        :class:`TransducerGreedySearcherStreamingContext`, which it
        updates."""
        init = None
        if context.hidden is not None:
            init = (context.last_token, context.hidden)
        hyps, _, _, _, (last_tok, hidden) = self.transducer_greedy_decode(
            x, hidden_state=init, return_hidden=True
        )
        context.hidden = hidden
        context.last_token = last_tok
        return hyps

    @staticmethod
    def _keep_where(flag, new, old):
        """``old`` on the rows where ``flag``, else ``new``, the rows on
        the state's batch axis."""
        shape = [1] * new.ndim
        shape[HIDDEN_BATCH_AXIS] = -1
        return torch.where(flag.reshape(shape), old, new)

    def _greedy(self, tn_output, init_carry=None):
        B, T, _ = tn_output.shape
        device = tn_output.device
        blank = self.blank_id
        max_sym = self.max_symbols_per_step
        out_buf = torch.full((B, T * max_sym), blank, dtype=torch.long,
                             device=device)
        out_pos = torch.zeros(B, dtype=torch.long, device=device)
        rows = torch.arange(B, device=device)
        if init_carry is not None:
            last_tok, hidden = init_carry
        else:
            last_tok = torch.full((B,), blank, dtype=torch.long,
                                  device=device)
            # the step gives the state's shapes; the state starts at zero
            _, hidden = self.pred_step(last_tok[:, None], None)
            hidden = _map(torch.zeros_like, hidden)
        for t in range(T):
            enc_t = tn_output[:, t:t + 1]
            done = torch.zeros(B, dtype=torch.bool, device=device)
            for _ in range(max_sym):
                log_probs, new_hidden = self._step_log_probs(
                    enc_t, last_tok[:, None], hidden)
                pred = torch.argmax(log_probs, dim=-1)
                is_blank = (pred == blank) | done
                out_buf[rows, out_pos] = torch.where(is_blank, blank, pred)
                out_pos = out_pos + (~is_blank).long()
                last_tok = torch.where(is_blank, last_tok, pred)
                hidden = _map(lambda n, o: self._keep_where(is_blank, n, o),
                              new_hidden, hidden)
                done = is_blank
        return out_buf.cpu(), (last_tok, hidden)

    # -- beam (on the host, one utterance at a time) ------------------------
    @torch.no_grad()
    def transducer_beam_search_decode(self, tn_output):
        B, T, _ = tn_output.shape
        device = tn_output.device
        use_lm = self.lm is not None and self.lm_weight > 0

        def rank(h):
            return h["logp_score"] / len(h["prediction"])

        nbest_batch, nbest_batch_score, best_hyps = [], [], []
        for b in range(B):
            hyps = [{"prediction": [self.blank_id], "logp_score": 0.0,
                     "hidden": None, "lm_hidden": None}]
            for t in range(T):
                enc_t = tn_output[b:b + 1, t:t + 1]
                process = list(hyps)
                hyps = []
                while len(hyps) < self.beam_size and process:
                    best = max(process, key=rank)
                    process.remove(best)
                    if hyps:
                        a_best = max(hyps, key=rank)
                        if rank(a_best) >= self.state_beam + rank(best):
                            break
                    tok = torch.tensor([[best["prediction"][-1]]],
                                       dtype=torch.long, device=device)
                    log_probs, hidden = self._step_log_probs(
                        enc_t, tok, best["hidden"])
                    lm_hidden = None
                    if use_lm:
                        lm_logits, lm_hidden = self.lm(tok, best["lm_hidden"])
                        lm_logp = torch.log_softmax(
                            lm_logits[:, -1].float(), dim=-1)
                        log_probs, lm_logp = torch.cat(
                            [log_probs, lm_logp]).cpu().numpy()
                    else:
                        log_probs = log_probs.cpu().numpy()[0]
                    # blank: the hypothesis stays, one frame on
                    hyps.append({
                        "prediction": best["prediction"],
                        "logp_score": best["logp_score"]
                        + float(log_probs[self.blank_id]),
                        "hidden": best["hidden"],
                        "lm_hidden": best["lm_hidden"],
                    })
                    # the top beam_size labels (blank counted) that lie
                    # within expand_beam of the best non-blank one
                    order = np.argsort(log_probs)[::-1]
                    best_logp = (log_probs[order[0]]
                                 if order[0] != self.blank_id
                                 else log_probs[order[1]])
                    for k in order[:self.beam_size]:
                        if k == self.blank_id:
                            continue
                        if log_probs[k] < best_logp - self.expand_beam:
                            continue
                        score = best["logp_score"] + float(log_probs[k])
                        if use_lm:
                            score += self.lm_weight * float(lm_logp[k])
                        process.append({
                            "prediction": best["prediction"] + [int(k)],
                            "logp_score": score,
                            "hidden": hidden,
                            "lm_hidden": lm_hidden,
                        })
            nbest = sorted(hyps, key=rank, reverse=True)[:self.nbest]
            best_hyps.append(nbest[0]["prediction"][1:])
            nbest_batch.append([h["prediction"][1:] for h in nbest])
            nbest_batch_score.append([rank(h) for h in nbest])
        return (best_hyps, [s[0] for s in nbest_batch_score], nbest_batch,
                nbest_batch_score)
