"""Source separation interface (port of
``speechbrain_tpu/inference/separation.py``: ``SepformerSeparation`` with
``separate_batch`` and ``separate_file``).

Runs under ``torch.no_grad()`` on the interface's device (the card unless
``run_opts`` ask otherwise), with the modules in ``eval()`` mode.
"""

import torch

from speechbrain_tpu_torch.inference.interfaces import Pretrained
from speechbrain_tpu_torch.lobes.models.dual_path import apply_masks


class SepformerSeparation(Pretrained):
    """Separate a mixture into its sources with a SepFormer-family model.

    modules: ``encoder``, ``masknet`` and ``decoder`` (the upstream
    three-module checkpoint; ``masknet`` gives (n_spks, B, T', N) masks);
    or ``masknet`` alone, a whole wrapper (mixture -> (B, T, n_spks)); or
    none, and the hparams' ``separator``, a callable. hparams:
    ``sample_rate`` for ``separate_file`` (16000 where none is given).
    """

    @torch.no_grad()
    def separate_batch(self, mix):
        """(B, T) mixtures -> (B, T, n_spks) sources. With the three
        modules: encoder -> masknet -> each source's masked latent
        through the decoder, padded or cut to the input's length."""
        mods = self.mods
        if all(name in mods for name in ("encoder", "masknet", "decoder")):
            return apply_masks(mods.encoder, mods.masknet, mods.decoder, mix)
        if "masknet" in mods:
            return mods.masknet(mix)
        return self.hparams.separator(mix)

    def separate_file(self, path, savedir="audio_cache"):
        """One file (averaged to mono, resampled to ``sample_rate``) ->
        (T, n_spks) sources, each scaled by its own peak."""
        est = self.separate_batch(self.load_audio(path)[None])
        peak = est.abs().amax(dim=1, keepdim=True)
        return (est / torch.clamp(peak, min=1e-9))[0]
