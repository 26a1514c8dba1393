#!/usr/bin/env python
"""LibriSpeech language model on the PyTorch port, the twin of
``recipes/LibriSpeech/LM/train.py`` with ``hparams/RNNLM.yaml`` (an
``RNNLM``) or ``hparams/transformer.yaml`` (a ``TransformerLM``): BPE or
unigram tokens -> the model -> NLL of the next token; AdamW
(``optax.adamw``'s defaults, weight decay 1e-4) annealed by NewBob on the
valid loss; a checkpoint kept by the lowest valid loss after every valid
stage. A trained RNNLM fuses into the CRDNN's beam search through
``RNNLMScorer`` and into the transducer's beam search as its
``lm_module``.

Text: one sentence per line in ``<data_folder>/lm_corpus.txt``, else the
``words`` of the train and valid manifests; a tenth of the lines (at least
one) goes to valid. Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.LM.train \\
        speechbrain_tpu_torch/recipes/LibriSpeech/LM/hparams/RNNLM.yaml \\
        --data_folder=results/lm_data --debug --device=cpu
"""

import json
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
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.losses import nll_loss
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece


class LM(Brain):
    """BOS + tokens -> log-probabilities of tokens + EOS; NLL."""

    def compute_forward(self, batch, stage):
        tokens_bos, _ = batch["tokens_bos"]
        out = self.modules.lm(tokens_bos)
        logits = out[0] if isinstance(out, tuple) else out
        return torch.log_softmax(logits.float(), -1)

    def compute_objectives(self, predictions, batch, stage):
        tokens_eos, lens = batch["tokens_eos"]
        return nll_loss(predictions, tokens_eos, length=lens)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        old_lr, new_lr = self.hparams.lr_annealing(stage_loss)
        update_learning_rate(self.optimizer, new_lr)
        if hasattr(self.hparams, "train_logger"):
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch, "lr": old_lr,
                            "valid_ppl": float(np.exp(stage_loss))},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
        if self.checkpointer is not None:
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])


def adamw(lr):
    """``optax.adamw`` at ``lr`` with its defaults: b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4 on every parameter."""
    return lambda params: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
    )


def load_sentences(hparams):
    """(train lines, valid lines): ``lm_corpus.txt`` if present, else the
    manifests' ``words``; the first tenth (at least one) is valid."""
    corpus = Path(hparams["data_folder"]) / "lm_corpus.txt"
    if corpus.exists():
        lines = [ln.strip() for ln in corpus.read_text().splitlines()
                 if ln.strip()]
    else:
        lines = []
        for key in ("train_annotation", "valid_annotation"):
            path = Path(hparams[key])
            if path.exists():
                with open(path, encoding="utf-8") as f:
                    lines += [e["words"] for e in json.load(f).values()]
    if not lines:
        raise FileNotFoundError(
            "no lm_corpus.txt and no manifests under data_folder"
        )
    n_valid = max(1, len(lines) // 10)
    return lines[n_valid:], lines[:n_valid]


def dataio_prepare(hparams, tokenizer, train_lines, valid_lines):
    datasets = {}
    for split, lines in (("train", train_lines), ("valid", valid_lines)):
        data = {f"{split}_{i}": {"words": ln} for i, ln in enumerate(lines)}
        ds = DynamicItemDataset(data)

        def tokens_pipeline(words):
            ids = tokenizer.sp.encode_as_ids(words)
            yield np.asarray([hparams["bos_index"]] + ids, np.int32)
            yield np.asarray(ids + [hparams["eos_index"]], np.int32)

        ds.add_dynamic_item(tokens_pipeline, takes="words",
                            provides=["tokens_bos", "tokens_eos"])
        ds.set_output_keys(["id", "tokens_bos", "tokens_eos"])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=LM):
    """The chain after the YAML step: a synthetic corpus under ``debug``
    where the train manifest is missing, the tokenizer trained on the
    train lines, the datasets, ``fit``. Returns ``(brain, datasets,
    tokenizer)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare_synthetic(
            hparams["data_folder"],
            save_folder=Path(hparams["train_annotation"]).parent,
        )
    train_lines, valid_lines = load_sentences(hparams)
    corpus_json = Path(hparams["save_folder"]) / "lm_text.json"
    corpus_json.parent.mkdir(parents=True, exist_ok=True)
    with open(corpus_json, "w", encoding="utf-8") as f:
        json.dump({f"u{i}": {"words": ln}
                   for i, ln in enumerate(train_lines)}, f)
    tokenizer = SentencePiece(
        model_dir=hparams["save_folder"],
        vocab_size=hparams["output_neurons"],
        annotation_train=str(corpus_json),
        annotation_read="words",
        model_type=hparams["token_type"],
        annotation_format="json",
    )
    datasets = dataio_prepare(hparams, tokenizer, train_lines, valid_lines)
    brain = brain_cls(
        modules={"lm": hparams["model"]},
        opt_class=adamw(hparams["lr"]),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    brain.fit(
        hparams["epoch_counter"],
        datasets["train"],
        datasets["valid"],
        train_loader_kwargs={"batch_size": hparams["batch_size"],
                             "shuffle": True},
        valid_loader_kwargs={"batch_size": hparams["batch_size"]},
    )
    return brain, datasets, tokenizer


def main(argv=None):
    hparams_file, run_opts, overrides = parse_arguments(argv)
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
    return run(hparams, run_opts)


if __name__ == "__main__":
    main(sys.argv[1:])
