#!/usr/bin/env python
"""RescueSpeech noise-robust ASR on the PyTorch port, the twin of
``recipes/RescueSpeech/ASR/noise-robust/train.py``: MetricGAN+'s BLSTM
masker (``enhancer``) cleans the noisy magnitudes, the enhanced speech is
resynthesised with the noisy phase, and a Conformer CTC model
(``TransformerASR.encode``, then ``ctc_head``) trains on its mel features
(the YAML's unfused, differentiable ``Fbank``: the gradient reaches the
enhancer through them); the loss is CTC plus ``enhance_weight`` times the
MSE of the enhanced against the clean magnitudes.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.RescueSpeech.ASR.noise-robust.train \\
        speechbrain_tpu_torch/recipes/RescueSpeech/ASR/noise-robust/hparams/train.yaml \\
        --data_folder=results/rescuespeech_data --debug --device=cpu
"""

import sys

import torch

from speechbrain_tpu_torch.nnet.losses import ctc_loss
from speechbrain_tpu_torch.processing.signal_processing import resynthesize
from speechbrain_tpu_torch.recipes.VoiceBank.MTL.ASR_enhance import (
    train as mtl,
)

WORDS = ("rescue", "help", "over")


class RobustASR(mtl.MTLBrain):
    """Enhancer -> resynthesis -> features -> Conformer encoder -> CTC."""

    def compute_forward(self, batch, stage):
        noisy, wav_lens = batch["noisy_sig"]
        noisy_mag = self.spec_mag(noisy)
        est_mag = noisy_mag * self.modules.enhancer(noisy_mag)
        est_wav = resynthesize(est_mag, noisy, self.hparams.compute_stft,
                               self.hparams.compute_istft)
        feats = self.hparams.compute_features(est_wav)
        enc = self.modules.encoder.encode(feats, wav_len=wav_lens)
        logits = self.modules.ctc_head(enc)
        return (torch.log_softmax(logits.float(), dim=-1), est_mag,
                self.spec_mag(batch["clean_sig"].data))

    def compute_objectives(self, predictions, batch, stage):
        p_ctc, est_mag, clean_mag = predictions
        wav_lens = batch["noisy_sig"].lengths
        chars, char_lens = batch["char_encoded"]
        asr = ctc_loss(p_ctc, chars, wav_lens, char_lens,
                       blank_index=self.hparams.blank_index)
        enh = torch.mean((est_mag.float() - clean_mag) ** 2)
        return asr + self.hparams.enhance_weight * enh, {"asr": asr,
                                                         "enh": enh}


def run(hparams, run_opts, brain_cls=RobustASR, export_from=None):
    """The MTL twin's ``run`` with this Brain."""
    return mtl.run(hparams, run_opts, brain_cls=brain_cls)


def prepare_corpus(hparams):
    """The ``--debug`` corpus: the MTL twin's with RescueSpeech's words."""
    mtl.prepare_synthetic(hparams["data_folder"], words=WORDS)


def main(argv=None):
    return mtl.main(argv, run_fn=run, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
