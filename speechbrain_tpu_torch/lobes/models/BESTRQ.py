"""BEST-RQ pretraining: span masks, the codeword cross-entropy and its
accuracy, and the batch-shared mask of the collate function (port of
``speechbrain_tpu/lobes/models/BESTRQ.py``).

:func:`compute_mask` is a host function: its draws come from a CPU
``torch.Generator`` through :func:`_uniform` and :func:`_permutation`.
"""

import numpy as np
import torch

from speechbrain_tpu_torch.lobes.models.wav2vec import w2v_mask
from speechbrain_tpu_torch.utils.data_utils import batch_pad_right


def brq_mask(shape, mask_prob, mask_length, generator=None, device="cuda"):
    """Span masks for BEST-RQ: :func:`wav2vec.w2v_mask`'s sampler."""
    return w2v_mask(shape, mask_prob, mask_length, generator, device)


def compute_brq_loss(logits, targets, mask):
    """Cross-entropy of the codeword ids ``targets`` ``(B, T)`` under
    ``logits`` ``(B, T, V)``, averaged over the frames of ``mask`` (at
    least one); float32.

    Example
    -------
    >>> logits = torch.zeros(1, 2, 4)
    >>> mask = torch.tensor([[True, False]])
    >>> round(compute_brq_loss(logits, torch.zeros(1, 2, dtype=torch.long),
    ...                        mask).item(), 4)
    1.3863
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    mask = mask.to(ll.dtype)
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def brq_accuracy(logits, targets, mask):
    """Top-1 accuracy of the codeword prediction over the frames of
    ``mask`` (at least one)."""
    correct = (logits.argmax(-1) == targets).float() * mask
    return correct.sum() / mask.float().sum().clamp_min(1.0)


def _uniform(generator):
    """One uniform [0, 1) draw as a Python float."""
    return float(torch.rand((), generator=generator))


def _permutation(n, generator):
    """A random permutation of ``range(n)`` as a numpy array."""
    return torch.randperm(n, generator=generator).numpy()


def compute_mask(shape, sample_lens, mask_prob, mask_length, generator=None):
    """Masked frame indices shared by the whole batch: of the shortest
    utterance's ``min_len`` frames, ``mask_prob * min_len`` spans (the
    fraction rounded up with that probability, at least one) on distinct
    ``mask_length``-aligned slots. Returns a 1-D int64 tensor of the
    masked frames, in increasing order.

    Example
    -------
    >>> idx = compute_mask((2, 50, 60), [40, 50], 0.15, 2,
    ...                    torch.Generator().manual_seed(0))
    >>> idx.shape[0] % 2 == 0, bool((idx < 40).all())
    (True, True)
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    min_len = int(min(sample_lens))
    frac = mask_prob * min_len
    num_mask = int(frac) + int(_uniform(generator) < (frac - int(frac)))
    num_mask = max(1, num_mask)
    n_slots = max(1, min_len // mask_length)
    perm = _permutation(n_slots, generator)[:num_mask]
    starts = np.sort(perm) * mask_length
    idx = np.concatenate([np.arange(s, s + mask_length) for s in starts])
    return torch.from_numpy(idx.astype(np.int64))


def brq_mask_collate_fn(samples_lst, get_out_len_fn, mask_prob, mask_length,
                        n_mels, generator=None):
    """Collate ``[{"id", "sig"}, ...]`` into ``(wavs, wav_lens, mask)``:
    the waveforms padded right, their relative lengths, and
    :func:`compute_mask` over the frame counts ``get_out_len_fn`` gives
    each waveform's length."""
    wav_lst, latent_lens = [], []
    for sample in samples_lst:
        sig = np.asarray(sample["sig"])
        wav_lst.append(sig)
        latent_lens.append(int(get_out_len_fn(sig.shape[-1])))
    wavs_padded, wav_lens = batch_pad_right(wav_lst)
    mask = compute_mask((len(wav_lst), max(latent_lens), n_mels),
                        latent_lens, mask_prob, mask_length, generator)
    return torch.from_numpy(wavs_padded), torch.from_numpy(wav_lens), mask
