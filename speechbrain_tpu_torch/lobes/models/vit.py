"""Vision-Transformer encoder over spectrogram "images" (port of
``speechbrain_tpu/lobes/models/vit.py``: ``ViTEncoder``).

The spectrogram is cut into patches by one strided ``valid`` convolution
(a tail shorter than a patch is dropped), a CLS token goes in front, the
first ``N + 1`` rows of a learned position table are added, and a
pre-norm ``TransformerEncoder`` runs over the tokens. Submodules and
parameters carry the flax names (``patch_embed``, ``cls_token``,
``pos_embed``, ``encoder``).
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerEncoder,
)
from speechbrain_tpu_torch.nnet.CNN import Conv2d


def _normal(shape, std, generator, device):
    gen_device = generator.device if generator is not None else "cpu"
    return (std * torch.randn(shape, generator=generator,
                              device=gen_device)).to(device)


class ViTEncoder(nn.Module):
    """(B, T, F) spectrogram -> ``(tokens, attns)``: tokens (B, 1 +
    N_patches, d_model), one attention map a layer; under
    ``return_reps`` ``(tokens, [spatial])`` with the patch tokens as a
    (B, T // pt, F // pf, d_model) map.

    Example
    -------
    >>> vit = ViTEncoder(d_model=16, nhead=4, num_layers=2, d_ffn=32,
    ...                  patch_size=(8, 8), device="cpu")
    >>> out, attns = vit(torch.ones(2, 32, 24))
    >>> out.shape
    torch.Size([2, 13, 16])
    """

    def __init__(self, d_model=768, nhead=12, num_layers=12, d_ffn=3072,
                 patch_size=(16, 16), dropout=0.0, max_patches=4096,
                 return_reps=False, in_channels=1, device="cuda",
                 generator=None):
        super().__init__()
        self.d_model = d_model
        self.return_reps = return_reps
        self.patch_embed = Conv2d(d_model, in_channels, tuple(patch_size),
                                  stride=tuple(patch_size), padding="valid",
                                  device=device, generator=generator)
        # N(0, 0.02), drawn on the generator's device (lecun_normal_'s rule)
        self.cls_token = nn.Parameter(_normal((1, 1, d_model), 0.02,
                                              generator, device))
        self.pos_embed = nn.Parameter(_normal((1, max_patches, d_model),
                                              0.02, generator, device))
        self.encoder = TransformerEncoder(
            num_layers=num_layers, nhead=nhead, d_ffn=d_ffn, d_model=d_model,
            dropout=dropout, normalize_before=True, device=device,
            generator=generator)

    def forward(self, x):
        B = x.shape[0]
        h = self.patch_embed(x[..., None] if x.ndim == 3 else x)
        gt, gf = h.shape[1], h.shape[2]
        h = h.reshape(B, gt * gf, self.d_model)
        h = torch.cat([self.cls_token.to(h.dtype).expand(B, 1, -1), h], 1)
        h = h + self.pos_embed[:, :h.shape[1]].to(h.dtype)
        out, attns = self.encoder(h)
        if self.return_reps:
            return out, [out[:, 1:].reshape(B, gt, gf, self.d_model)]
        return out, attns
