#!/usr/bin/env python
"""BayesSpeech on the PyTorch port: Bayesian transformer CTC/attention ASR
by Bayes by Backprop (arXiv:2301.11276), the twin of
``recipes/LibriSpeech/ASR/transformer/train_bayesspeech.py``.

Every parameter ``w`` of the four modules becomes a diagonal Gaussian
``(mu, rho)``: ``mu`` is the module's own parameter, ``rho`` (initialised
to ``RHO_INIT``) a parameter of the module ``rho`` (:class:`PosteriorRho`)
beside them, so both are in the optimizer and the checkpoint. A training
step draws ``w = mu + softplus(rho) * eps`` with ``eps`` from the Brain's
own ``torch.Generator`` and runs the modules on it through
``torch.func.functional_call``; the valid and test stages run on ``mu``.
The objective is the CTC/attention likelihood plus ``kl_div_weight``
times the closed-form KL of the posterior to N(0, ``prior_std``). Noam sets
AdamW's rate after every update.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train_bayesspeech \\
        speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transformer/hparams/bayesspeech.yaml \\
        --data_folder=results/bayes_data --debug --device=cpu
"""

import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.func import functional_call

from speechbrain_tpu_torch.core import (
    Brain,
    Stage,
    create_experiment_directory,
    parse_arguments,
)
from speechbrain_tpu_torch.nnet.losses import ctc_loss, kldiv_loss
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train import (
    SIG_PAD_MULTIPLE,
    adamw,
    dataio_prepare,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece

RHO_INIT = -5.0  # softplus(-5) ~ 6.7e-3, the posterior's first std
# the modules whose parameters are the posterior's means
POSTERIOR_MODULES = ("frontend", "model", "ctc_head", "seq_head")


class PosteriorRho(torch.nn.Module):
    """The ``rho`` of every parameter of ``modules`` (a dict of modules),
    filled with ``init``: ``rho[name]`` is a ``ParameterDict`` keyed by the
    module's parameter names with ``/`` for ``.``."""

    def __init__(self, modules, init=RHO_INIT):
        super().__init__()
        self.rho = torch.nn.ModuleDict({
            name: torch.nn.ParameterDict({
                pname.replace(".", "/"): torch.nn.Parameter(
                    torch.full_like(p.detach(), init))
                for pname, p in module.named_parameters()
            })
            for name, module in modules.items()
        })

    def get(self, name, pname):
        """The ``rho`` of parameter ``pname`` of module ``name``."""
        return self.rho[name][pname.replace(".", "/")]

    def pairs(self, modules):
        """``(module name, parameter name, mu, rho)`` of every parameter."""
        for name in self.rho:
            for pname, mu in modules[name].named_parameters():
                yield name, pname, mu, self.get(name, pname)

    def sample(self, modules, generator=None, eps=None):
        """``{module: {parameter: mu + softplus(rho) * eps}}``, ``eps``
        drawn from ``generator`` on each parameter's device, or taken
        from ``eps`` (the same nesting)."""
        theta = {name: {} for name in self.rho}
        for name, pname, mu, rho in self.pairs(modules):
            e = (eps[name][pname] if eps is not None else torch.randn(
                mu.shape, generator=generator, device=mu.device,
                dtype=mu.dtype))
            theta[name][pname] = mu + F.softplus(rho) * e
        return theta


def _kl_to_prior(pairs, prior_std):
    """Closed-form KL(N(mu, sigma) || N(0, prior_std)) summed over every
    weight, ``sigma = softplus(rho)``, over ``(mu, rho)`` pairs."""
    total = 0.0
    for mu, rho in pairs:
        sigma = F.softplus(rho)
        total = total + torch.sum(
            torch.log(prior_std / sigma)
            + (sigma ** 2 + mu ** 2) / (2.0 * prior_std ** 2) - 0.5)
    return total


class BayesASR(Brain):
    """The variational conformer CTC/attention Brain. ``modules`` gains a
    :class:`PosteriorRho` as ``rho`` where it has none; training draws the
    weights from ``self.sample_generator`` (seeded by the run's seed);
    ``last_kl`` holds the KL term of the last objective."""

    def __init__(self, modules=None, *args, **kwargs):
        modules = dict(modules)
        modules.setdefault("rho", PosteriorRho(
            {name: modules[name] for name in POSTERIOR_MODULES}))
        super().__init__(modules, *args, **kwargs)
        self.sample_generator = torch.Generator(device=self.device)
        self.sample_generator.manual_seed(self.run_opts.seed)
        self.last_kl = None

    def compute_forward(self, batch, stage):
        theta = None
        if stage == Stage.TRAIN:
            theta = self.modules.rho.sample(self.modules,
                                            self.sample_generator)
        return self.forward_with(batch, theta)

    def forward_with(self, batch, theta=None):
        """The CTC and seq log-probabilities at the weights ``theta``
        (:meth:`PosteriorRho.sample`'s nesting), at ``mu`` where None."""

        def call(name, *args, **kwargs):
            if theta is None:
                return self.modules[name](*args, **kwargs)
            return functional_call(self.modules[name], theta[name], args,
                                   kwargs)

        wavs, wav_lens = batch["sig"]
        tokens_bos, _ = batch["tokens_bos"]
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, wav_lens)
        feats = call("frontend", feats)
        enc, dec = call("model", feats, tokens_bos, wav_len=wav_lens)
        p_ctc = torch.log_softmax(call("ctc_head", enc).float(), -1)
        p_seq = torch.log_softmax(call("seq_head", dec).float(), -1)
        return p_ctc, p_seq

    def kl_to_prior(self):
        return _kl_to_prior(
            ((mu, rho) for _, _, mu, rho in
             self.modules.rho.pairs(self.modules)),
            self.hparams.prior_std)

    def compute_objectives(self, predictions, batch, stage):
        p_ctc, p_seq = predictions
        _, wav_lens = batch["sig"]
        tokens, tok_lens = batch["tokens"]
        tokens_eos, tok_eos_lens = batch["tokens_eos"]
        w = self.hparams.ctc_weight
        likelihood = w * ctc_loss(
            p_ctc, tokens, wav_lens, tok_lens,
            blank_index=self.hparams.blank_index,
        ) + (1 - w) * kldiv_loss(
            p_seq, tokens_eos, length=tok_eos_lens,
            label_smoothing=self.hparams.label_smoothing,
        )
        complexity = self.kl_to_prior()
        self.last_kl = complexity.detach()
        return likelihood + self.hparams.kl_div_weight * complexity

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        if should_step:
            _, new_lr = self.hparams.noam_scheduler(None)
            update_learning_rate(self.optimizer, new_lr)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.TRAIN:
            return
        if hasattr(self.hparams, "train_logger"):
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch,
                            "lr": self.hparams.noam_scheduler.current_lr},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
        if self.checkpointer is not None:
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])


def run(hparams, run_opts, brain_cls=BayesASR):
    """The chain after the YAML step: a synthetic corpus under ``debug``
    where the train manifest is missing, the tokenizer, the datasets,
    ``fit`` with a shuffled train loader. Returns ``(brain, datasets,
    tokenizer)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare_synthetic(
            hparams["data_folder"],
            save_folder=Path(hparams["train_annotation"]).parent,
        )
    tokenizer = SentencePiece(
        model_dir=hparams["save_folder"],
        vocab_size=hparams["vocab_size"],
        annotation_train=hparams["train_annotation"],
        annotation_read="words",
        model_type=hparams["token_type"],
        annotation_format="json",
    )
    datasets = dataio_prepare(hparams, tokenizer)
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=adamw(hparams["lr_adam"]),
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
    return brain, datasets, tokenizer


def main(argv=None):
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
    return run(hparams, run_opts)


if __name__ == "__main__":
    main(sys.argv[1:])
