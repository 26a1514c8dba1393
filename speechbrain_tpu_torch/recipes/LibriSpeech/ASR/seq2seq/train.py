#!/usr/bin/env python
"""LibriSpeech CRDNN attention seq2seq ASR on the PyTorch port, the twin of
``recipes/LibriSpeech/ASR/seq2seq/train.py``.

Fbank -> sentence normalisation -> CRDNN encoder -> GRU decoder with
location-aware attention; a joint objective of CTC (weight 0.5, held for
the whole run, as the JAX script holds it) and label-smoothed NLL over BPE
targets; Adadelta (lr 1.0, rho 0.95, eps 1e-8) annealed by NewBob on the
valid loss; batches padded to whole seconds; a checkpoint kept by the
lowest valid loss after every valid stage. Outside ``--debug`` the test
split is beam-searched (``test_beam_size``) and its WER written to
``wer_test.txt``.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing; without ``--device=cpu`` the
modules and the Brain go to the card):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq.train \\
        speechbrain_tpu_torch/recipes/LibriSpeech/ASR/seq2seq/hparams/train_BPE_1000.yaml \\
        --data_folder=results/crdnn_data --debug --device=cpu

Everything after the YAML step is :func:`run`, which takes a plain dict of
hyperparameters. The search pieces (:func:`rnn_search_fns`,
:func:`rnnlm_fns`, :func:`make_rnn_searcher` and :class:`RNNSearchDecoder`,
the ``decoder`` an ``EncoderDecoderASR`` serves through) live here too.
"""

import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.core import (
    Brain,
    Stage,
    create_experiment_directory,
    parse_arguments,
)
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.decoders.scorer import (
    CoverageScorer,
    CTCScorer,
    LengthScorer,
    RNNLMScorer,
    ScorerBuilder,
)
from speechbrain_tpu_torch.decoders.seq2seq import S2SRNNBeamSearcher
from speechbrain_tpu_torch.nnet.attention import uniform_attention
from speechbrain_tpu_torch.nnet.losses import ctc_loss, nll_loss
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece
from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats

# waveforms are padded to whole seconds (train.py:264-266)
SIG_PAD_MULTIPLE = 16000


def rnn_search_fns(emb, dec, seq_lin, temperature=1.0):
    """``(step_fn, init_fn)`` of an ``S2SRNN*Searcher`` over an embedding,
    an ``AttentionalRNNDecoder`` and its output head: a step embeds the
    consumed tokens, runs ``dec.forward_step`` and returns the head's
    log-softmax of ``logits / temperature``; the state starts from
    ``dec.init_state`` with a float32 ``prev_attn`` uniform over each row's
    valid frames."""

    def step_fn(inp_tokens, memory, enc_states, enc_lens):
        e = emb(inp_tokens[:, None])[:, 0]
        out, new_state, attn = dec.forward_step(e, memory, enc_states,
                                                enc_lens)
        logits = seq_lin(out).float()
        return torch.log_softmax(logits / temperature, dim=-1), new_state, \
            attn

    def init_fn(batch_size, enc_states, enc_lens):
        T = enc_states.shape[1]
        state = dec.init_state(batch_size, T, device=enc_states.device)
        state["prev_attn"] = uniform_attention(enc_lens, T)
        return state

    return step_fn, init_fn


def rnnlm_fns(lm):
    """``(lm_fn, lm_init)`` of an ``RNNLMScorer`` over an ``RNNLM``: the
    scorer's state is the LSTM's ``(h, c)`` batch-leading, ``(N, layers,
    H)``, moved to the LSTM's ``(layers, N, H)`` at the boundary."""
    rnn = lm.rnn

    def lm_fn(tokens, state):
        hx = tuple(t.transpose(0, 1).contiguous() for t in state)
        logits, new_state = lm(tokens, hx=hx)
        return logits, tuple(t.transpose(0, 1) for t in new_state)

    def lm_init(n):
        z = torch.zeros((n, rnn.num_layers * rnn.dirs, rnn.hidden_size),
                        device=rnn.wh[0].device)
        return (z, z)

    return lm_fn, lm_init


def make_rnn_searcher(emb, dec, seq_lin, beam_size, bos_index, eos_index,
                      ctc_lin=None, lm=None, blank_index=0, vocab_size=None,
                      ctc_weight=0.0, lm_weight=0.0, coverage_penalty=0.0,
                      length_reward=0.0, temperature=1.0, temperature_lm=1.0,
                      device=None, **searcher_kwargs):
    """An ``S2SRNNBeamSearcher`` over the decoder, fused through a
    ``ScorerBuilder`` with what has a weight above 0: ``CTCScorer`` (over
    ``ctc_lin``'s log-softmax), ``RNNLMScorer`` (over ``lm``),
    ``CoverageScorer`` and ``LengthScorer``. ``searcher_kwargs`` go to the
    searcher (``min_decode_ratio``, ``max_decode_ratio``,
    ``eos_threshold``, ``using_max_attn_shift``, ``max_attn_shift``...)."""
    weights, full, partial = {}, {}, {}
    if ctc_weight > 0:
        weights["ctc"] = ctc_weight
        partial["ctc"] = CTCScorer(
            lambda x: torch.log_softmax(ctc_lin(x).float(), dim=-1),
            blank_index=blank_index, eos_index=eos_index,
        )
    if lm_weight > 0:
        weights["rnnlm"] = lm_weight
        full["rnnlm"] = RNNLMScorer(*rnnlm_fns(lm), temperature=temperature_lm)
    if coverage_penalty > 0:
        weights["coverage"] = coverage_penalty
        full["coverage"] = CoverageScorer(vocab_size=vocab_size)
    if length_reward > 0:
        weights["length"] = length_reward
        full["length"] = LengthScorer(vocab_size=vocab_size)
    scorer = ScorerBuilder(weights, full, partial) if weights else None
    step_fn, init_fn = rnn_search_fns(emb, dec, seq_lin, temperature)
    device = device or seq_lin.weight.device
    return S2SRNNBeamSearcher(
        step_fn=step_fn, init_fn=init_fn, bos_index=bos_index,
        eos_index=eos_index, beam_size=beam_size, scorer=scorer,
        device=device, **searcher_kwargs,
    )


class RNNSearchDecoder(torch.nn.Module):
    """The beam search as the ``decoder`` of an ``EncoderDecoderASR``:
    ``(encoder states, relative lengths) -> (hyps, lengths, scores,
    topk)``. The modules are its children, so that the interface moves
    them to its device and puts them in ``eval()`` without gradients; the
    searcher (:func:`make_rnn_searcher` with ``search_kwargs``) is built
    for each call on the states' device, and kept (``searcher``) with its
    result (``last_result``)."""

    def __init__(self, emb, dec, seq_lin, ctc_lin=None, lm=None,
                 **search_kwargs):
        super().__init__()
        self.emb, self.dec, self.seq_lin = emb, dec, seq_lin
        self.ctc_lin, self.lm = ctc_lin, lm
        self.search_kwargs = search_kwargs
        self.searcher = self.last_result = None

    def forward(self, enc_states, enc_lens):
        self.searcher = make_rnn_searcher(
            self.emb, self.dec, self.seq_lin, ctc_lin=self.ctc_lin,
            lm=self.lm, device=enc_states.device, **self.search_kwargs,
        )
        self.last_result = self.searcher(enc_states, enc_lens)
        return self.last_result


class ASR(Brain):
    """The recipe's Brain: waveform -> Fbank -> sentence normalisation ->
    CRDNN -> (CTC head; embedding of BOS + tokens -> attentional GRU
    decoder -> seq head) -> ``ctc_weight`` CTC + the rest label-smoothed
    NLL. After every valid stage NewBob anneals the optimizer's rate on
    the valid loss, a line goes to the train log and a checkpoint is kept
    by the lowest valid loss (each where the Brain has a logger and a
    checkpointer). The CRDNN's BatchNorm uses the batch's statistics and
    moves its running ones in training, and normalises with the running
    ones in the valid and test stages, as the Brain's ``train()`` and
    ``eval()`` of the modules say."""

    def compute_forward(self, batch, stage):
        wavs, wav_lens = batch["sig"]
        tokens_bos, _ = batch["tokens_bos"]
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, wav_lens)
        enc = self.modules.enc(feats)
        emb = self.modules.emb(tokens_bos)
        dec_out, _ = self.modules.dec(emb, enc, wav_lens)
        p_seq = torch.log_softmax(self.modules.seq_lin(dec_out).float(), -1)
        p_ctc = torch.log_softmax(self.modules.ctc_lin(enc).float(), -1)
        return p_ctc, p_seq

    def compute_objectives(self, predictions, batch, stage):
        p_ctc, p_seq = predictions
        _, wav_lens = batch["sig"]
        tokens, tok_lens = batch["tokens"]
        tokens_eos, tok_eos_lens = batch["tokens_eos"]
        w = self.hparams.ctc_weight
        loss_ctc = ctc_loss(p_ctc, tokens, wav_lens, tok_lens,
                            blank_index=self.hparams.blank_index)
        loss_seq = nll_loss(p_seq, tokens_eos, length=tok_eos_lens,
                            label_smoothing=self.hparams.label_smoothing)
        return w * loss_ctc + (1 - w) * loss_seq

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        old_lr, new_lr = self.hparams.lr_annealing(stage_loss)
        update_learning_rate(self.optimizer, new_lr)
        if hasattr(self.hparams, "train_logger"):
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch, "lr": old_lr},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
        if self.checkpointer is not None:
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])

    def make_searcher(self, beam_size, **kwargs):
        """An ``S2SRNNBeamSearcher`` over the trained decoder with the
        recipe's decode settings (min/max decode ratio, eos threshold);
        ``kwargs`` add scorers and settings (:func:`make_rnn_searcher`)."""
        h = self.hparams
        settings = dict(min_decode_ratio=h.min_decode_ratio,
                        max_decode_ratio=h.max_decode_ratio,
                        eos_threshold=h.eos_threshold,
                        vocab_size=h.output_neurons,
                        blank_index=h.blank_index)
        settings.update(kwargs)
        return make_rnn_searcher(
            self.modules.emb, self.modules.dec, self.modules.seq_lin,
            beam_size, h.bos_index, h.eos_index,
            ctc_lin=self.modules.ctc_lin, device=self.device, **settings,
        )

    @torch.no_grad()
    def transcribe_dataset(self, dataset, tokenizer, beam_size=8):
        """Beam-search a dataset (the modules in ``eval()``) and return its
        ``ErrorRateStats``."""
        searcher = self.make_searcher(beam_size)
        wer = ErrorRateStats()
        loader = self.make_dataloader(
            dataset, Stage.TEST, ckpt_prefix=None,
            batch_size=self.hparams.test_batch_size,
        )
        self.modules.eval()
        for batch in loader:
            batch = self._prepare_batch(batch)
            wavs, wav_lens = batch["sig"]
            feats = self.hparams.compute_features(wavs)
            feats = self.hparams.normalize(feats, wav_lens)
            hyps, _, _, _ = searcher(self.modules.enc(feats), wav_lens)
            preds = [tokenizer.sp.decode_ids(h).split() for h in hyps]
            wer.append(batch.id, preds, [w.split() for w in batch.words])
        return wer


def adadelta(lr):
    """The recipe's optimizer, ``optax.adadelta`` at ``lr`` with rho 0.95
    and eps 1e-8 (``torch.optim.Adadelta``'s update is the same)."""
    return lambda params: torch.optim.Adadelta(params, lr=lr, rho=0.95,
                                               eps=1e-8)


def dataio_prepare(hparams, tokenizer):
    """Manifests -> datasets that read the audio and encode the words into
    BPE ids (``tokens``, ``tokens_bos``, ``tokens_eos``), the words kept
    beside them for scoring. The train split is sorted by length; a
    missing test manifest is skipped."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation"),
                       ("test", "test_annotation")):
        path = hparams[key]
        if not Path(path).exists():
            if split == "test":
                continue
            raise FileNotFoundError(
                f"{path} missing; run librispeech_prepare.py first"
            )
        ds = DynamicItemDataset.from_json(
            path, replacements={"data_root": hparams["data_folder"]}
        )
        if split == "train":
            ds = ds.filtered_sorted(sort_key="length")
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")

        def tokens_pipeline(words):
            ids = tokenizer.sp.encode_as_ids(words)
            yield np.asarray(ids, np.int32)
            yield np.asarray([hparams["bos_index"]] + ids, np.int32)
            yield np.asarray(ids + [hparams["eos_index"]], np.int32)

        ds.add_dynamic_item(
            tokens_pipeline, takes="words",
            provides=["tokens", "tokens_bos", "tokens_eos"],
        )
        ds.set_output_keys(
            ["id", "sig", "words", "tokens", "tokens_bos", "tokens_eos"]
        )
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=ASR, prepare=prepare_synthetic):
    """The chain after the YAML step: a synthetic corpus (``prepare``)
    under ``run_opts["debug"]`` where the train manifest is missing, the
    tokenizer, the datasets, ``fit`` with a shuffled train loader, then
    (outside ``debug``) the test split's beam search and WER. Returns
    ``(brain, datasets, tokenizer)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare(
            hparams["data_folder"],
            save_folder=Path(hparams["train_annotation"]).parent,
        )
    tokenizer = SentencePiece(
        model_dir=hparams["save_folder"],
        vocab_size=hparams["output_neurons"],
        annotation_train=hparams["train_annotation"],
        annotation_read="words",
        model_type=hparams["token_type"],
        annotation_format="json",
    )
    datasets = dataio_prepare(hparams, tokenizer)
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=adadelta(hparams["lr"]),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    loader = {"batch_size": hparams["batch_size"],
              "pad_to_multiple": {"sig": SIG_PAD_MULTIPLE}}
    brain.fit(
        hparams["epoch_counter"],
        datasets["train"],
        datasets["valid"],
        train_loader_kwargs=dict(loader, shuffle=True),
        valid_loader_kwargs=loader,
    )
    if "test" in datasets and not run_opts.get("debug"):
        wer = brain.transcribe_dataset(
            datasets["test"], tokenizer, beam_size=hparams["test_beam_size"]
        )
        with open(Path(hparams["output_folder"]) / "wer_test.txt", "w") as f:
            wer.write_stats(f)
    return brain, datasets, tokenizer


def main(argv=None, run_fn=run):
    hparams_file, run_opts, overrides = parse_arguments(argv)
    # the modules the YAML builds go to the Brain's device
    if "device" in run_opts:
        overrides["device"] = run_opts["device"]
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    with open(hparams_file, encoding="utf-8") as f:
        hparams = load_hyperpyyaml(f, overrides)
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file,
        overrides=overrides,
    )
    return run_fn(hparams, run_opts)


if __name__ == "__main__":
    main(sys.argv[1:])
