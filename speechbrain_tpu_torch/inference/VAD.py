"""Voice activity detection (port of ``speechbrain_tpu/inference/VAD.py``):
chunked neural posteriors -> hysteresis thresholding -> boundaries ->
merge and remove -> optional energy refinement -> a double check of each
segment by the model.

The posteriors are computed and recombined on the interface's device
(the card unless ``run_opts`` ask otherwise); only the boundary logic,
which is sequential (the hysteresis) and ragged (the segment lists), runs
on the host in numpy, as in JAX. Boundaries are numpy ``(n, 2)`` arrays
of seconds.

Every method that takes an ``audio_file`` also takes the audio itself, a
1-D tensor at ``hparams.sample_rate``: :meth:`VAD.get_speech_segments`
reads the file once and hands the tensor to each stage, where JAX's
stages read it again.

The default mode of :meth:`VAD.get_speech_prob_file` keeps ``chunk /
hop`` frames of each chunk: a centred ``Fbank`` gives one frame more (the
centre-padded frame at the chunk's end, which the next chunk's first
frame repeats), and JAX keeps it, so its posteriors drift a frame later
with each chunk (ROADMAP C51).
"""

import numpy as np
import torch

from speechbrain_tpu_torch.inference.interfaces import Pretrained


class VAD(Pretrained):
    """Speech/non-speech detection.

    hparams: ``compute_features`` (waveforms -> features), optionally
    ``mean_var_norm`` (``(feats, lengths) -> feats``), ``sample_rate``,
    optionally ``time_resolution`` (seconds a frame, 0.01 when absent);
    modules: ``model`` (features -> (B, frames, 1) speech logits, or
    (B, frames, C) logits whose last class is speech).
    """

    HPARAMS_NEEDED = ["sample_rate"]
    MODULES_NEEDED = ["model"]

    def _audio(self, audio_file):
        """The audio: ``audio_file`` itself when it is a tensor (moved to
        the device), else the file read by ``load_audio``."""
        if torch.is_tensor(audio_file):
            return audio_file.to(self.device)
        return self.load_audio(audio_file)

    def _resolution(self):
        return getattr(self.hparams, "time_resolution", 0.01)

    def _n_frames(self, n_samples):
        return int(n_samples / (self.hparams.sample_rate * self._resolution()))

    @torch.no_grad()
    def get_speech_prob_chunk(self, wavs, wav_lens=None):
        """Frame-level speech posteriors (B, frames, 1) of a batch of
        chunks (B, T), on the device."""
        wavs = torch.as_tensor(wavs).to(self.device)
        feats = self.hparams.compute_features(wavs)
        mean_var_norm = getattr(self.hparams, "mean_var_norm", None)
        if mean_var_norm:
            if wav_lens is None:
                wav_lens = torch.ones(wavs.shape[0], device=self.device)
            feats = mean_var_norm(feats, wav_lens.to(self.device))
        out = self.mods.model(feats)
        if out.shape[-1] == 1:
            return torch.sigmoid(out)
        return torch.softmax(out, dim=-1)[..., -1:]

    @torch.no_grad()
    def get_speech_prob_file(self, audio_file, large_chunk_size=30,
                             small_chunk_size=10, overlap_small_chunk=False):
        """Posteriors (1, frames, 1) over a whole file, on the device: the
        audio cut into chunks of ``small_chunk_size`` seconds, all of them
        run as one batch (``large_chunk_size`` is taken for the
        reference's signature; JAX does not read it either). By default
        the chunks are consecutive and each gives ``chunk / hop`` frames;
        with ``overlap_small_chunk`` they overlap by half and their
        posteriors are recombined with Hamming weights."""
        audio = self._audio(audio_file)
        sr = self.hparams.sample_rate
        chunk_len = int(small_chunk_size * sr)
        T = audio.shape[0]
        if not overlap_small_chunk:
            n_chunks = -(-T // chunk_len)
            audio = torch.nn.functional.pad(audio, (0, n_chunks * chunk_len
                                                    - T))
            probs = self.get_speech_prob_chunk(
                audio.reshape(n_chunks, chunk_len))
            # a chunk's own frames; the one more that a centred Fbank
            # gives repeats the next chunk's first (C51)
            probs = probs[:, : self._n_frames(chunk_len)]
            return probs.reshape(1, -1, 1)[:, : self._n_frames(T)]
        stride = chunk_len // 2
        n_chunks = max(1, -(-max(T - chunk_len, 0) // stride) + 1)
        needed = (n_chunks - 1) * stride + chunk_len
        audio = torch.nn.functional.pad(audio, (0, max(0, needed - T)))
        chunks = self.create_chunks(audio[None], chunk_size=chunk_len,
                                    chunk_stride=stride)
        probs = self.get_speech_prob_chunk(chunks)[..., 0]  # (N, F)
        n, F = probs.shape
        hop = F // 2
        w = torch.hamming_window(F, periodic=False, dtype=torch.float64,
                                 device=probs.device)
        total = self._n_frames(needed)
        length = (n - 1) * hop + F
        # overlap-add of the weighted posteriors and of the weights
        fold = torch.nn.functional.fold
        stacked = torch.stack([probs.double() * w, w.expand(n, F)])
        acc, weight = fold(stacked.transpose(1, 2), (1, length), (1, F),
                           stride=(1, hop))[:, 0, 0]
        out = acc[:total] / weight[:total].clamp(min=1e-8)
        return out.to(probs.dtype)[None, : self._n_frames(T), None]

    @staticmethod
    def create_chunks(x, chunk_size=16384, chunk_stride=16384):
        """A (1, T) signal as ``max(1, (T - chunk_size) // chunk_stride +
        1)`` strided chunks (N, chunk_size); a signal shorter than a chunk
        repeats its last sample."""
        x = torch.as_tensor(x).reshape(-1)
        n = max(1, (len(x) - chunk_size) // chunk_stride + 1)
        idx = (torch.arange(n, device=x.device)[:, None] * chunk_stride
               + torch.arange(chunk_size, device=x.device)[None, :])
        return x[idx.clamp(max=len(x) - 1)]

    def upsample_VAD(self, vad_out, audio_file, time_resolution=0.01):
        """Frame decisions -> a sample-level (1, T, 1) signal aligned with
        the audio, zero past the last frame."""
        T = self._audio(audio_file).shape[0]
        frame = int(time_resolution * self.hparams.sample_rate)
        vad = torch.as_tensor(vad_out, device=self.device).reshape(-1)
        up = torch.repeat_interleave(vad, frame)[:T]
        up = torch.nn.functional.pad(up, (0, T - len(up)))
        return up[None, :, None]

    def upsample_boundaries(self, boundaries, audio_file):
        """``[start, end]`` seconds -> a sample-level (1, T, 1) signal, 1
        inside the segments."""
        T = self._audio(audio_file).shape[0]
        sr = self.hparams.sample_rate
        sig = torch.zeros(T, device=self.device)
        for s, e in np.asarray(boundaries).reshape(-1, 2):
            sig[int(s * sr): int(e * sr)] = 1.0
        return sig[None, :, None]

    def get_segments(self, boundaries, audio_file, before_margin=0.1,
                     after_margin=0.1):
        """The audio of each segment, widened by the margins (seconds)
        and cut at the audio's ends: a list of 1-D tensors."""
        audio = self._audio(audio_file)
        sr = self.hparams.sample_rate
        T = audio.shape[0]
        segments = []
        for s, e in np.asarray(boundaries).reshape(-1, 2):
            beg = max(0, int((s - before_margin) * sr))
            end = min(T, int((e + after_margin) * sr))
            segments.append(audio[beg:end])
        return segments

    def save_boundaries(self, boundaries, save_path=None,
                        print_boundaries=True, audio_file=None):
        """The segments as alternating ``SPEECH``/``NON_SPEECH`` rows
        covering the whole audio (up to the last boundary when no audio
        is given), printed and/or written to ``save_path``; returns the
        lines."""
        boundaries = np.asarray(boundaries).reshape(-1, 2)
        last = 0.0
        if audio_file is not None:
            total = self._audio(audio_file).shape[0] / (
                self.hparams.sample_rate)
        else:
            total = boundaries[-1, 1] if len(boundaries) else 0.0
        rows = []
        events = list(boundaries) + [[total, total]]
        for s, e in events:
            if s > last:
                rows.append((last, s, "NON_SPEECH"))
            if e > s:
                rows.append((s, e, "SPEECH"))
            last = max(last, e)
        lines = [
            f"segment_{i + 1:03d}  {s:.2f}  {e:.2f} {label}"
            for i, (s, e, label) in enumerate(rows)
        ]
        text = "\n".join(lines)
        if print_boundaries:
            print(text)
        if save_path is not None:
            with open(save_path, "w") as f:
                f.write(text + "\n")
        return lines

    @staticmethod
    def apply_threshold(vad_prob, activation_th=0.5, deactivation_th=0.25):
        """Hysteresis on (B, frames, 1) posteriors: a frame turns speech
        at ``activation_th`` and stays so until a frame falls below
        ``deactivation_th``. A sequential loop on the host; returns a
        numpy array of 0/1 of the posteriors' shape."""
        if torch.is_tensor(vad_prob):
            vad_prob = vad_prob.cpu().numpy()
        vad_prob = np.asarray(vad_prob)
        vad = np.zeros_like(vad_prob)
        for b in range(vad_prob.shape[0]):
            active = False
            row = vad[b, :, 0]
            for t, p in enumerate(vad_prob[b, :, 0].tolist()):
                if not active and p >= activation_th:
                    active = True
                elif active and p < deactivation_th:
                    active = False
                row[t] = 1.0 if active else 0.0
        return vad

    def get_boundaries(self, prob_th, output_value="seconds"):
        """0/1 frame decisions (B, frames, 1) -> an (n, 2) array of
        ``[start, end]`` in seconds (or frame indices), every row of the
        batch in turn."""
        if torch.is_tensor(prob_th):
            prob_th = prob_th.cpu().numpy()
        prob_th = np.asarray(prob_th)
        res = self._resolution()
        boundaries = []
        for b in range(prob_th.shape[0]):
            x = prob_th[b, :, 0]
            diff = np.diff(np.concatenate([[0.0], x, [0.0]]))
            starts = np.where(diff == 1)[0]
            ends = np.where(diff == -1)[0]
            for s, e in zip(starts, ends):
                if output_value == "seconds":
                    boundaries.append([s * res, e * res])
                else:
                    boundaries.append([int(s), int(e)])
        return np.asarray(boundaries).reshape(-1, 2)

    @staticmethod
    def merge_close_segments(boundaries, close_th=0.25):
        """Merge segments whose gap is at most ``close_th`` seconds."""
        if len(boundaries) == 0:
            return boundaries
        out = [list(boundaries[0])]
        for seg in boundaries[1:]:
            if seg[0] - out[-1][1] <= close_th:
                out[-1][1] = seg[1]
            else:
                out.append(list(seg))
        return np.asarray(out)

    @staticmethod
    def remove_short_segments(boundaries, len_th=0.25):
        """Drop segments shorter than ``len_th`` seconds."""
        if len(boundaries) == 0:
            return boundaries
        keep = [seg for seg in boundaries if seg[1] - seg[0] >= len_th]
        return np.asarray(keep).reshape(-1, 2)

    def energy_VAD(self, audio_file, boundaries, activation_th=0.5,
                   deactivation_th=0.0, eps=1e-6):
        """Split each segment where its frames' log energy, scaled to
        [0, 1] within the segment, exceeds ``activation_th``. As in JAX,
        ``deactivation_th`` is not read (a single threshold; ROADMAP).
        Host numpy on the float32 audio, as JAX computes it."""
        audio = self._audio(audio_file).cpu().numpy()
        sr = self.hparams.sample_rate
        res = self._resolution()
        frame = int(res * sr)
        refined = []
        for s, e in boundaries:
            seg = audio[int(s * sr): int(e * sr)]
            if len(seg) < frame:
                continue
            n = len(seg) // frame
            energies = np.log(
                (seg[: n * frame].reshape(n, frame) ** 2).mean(axis=1) + eps)
            energies = (energies - energies.min()) / max(
                energies.max() - energies.min(), eps)
            active = energies > activation_th
            diff = np.diff(np.concatenate([[0], active.astype(int), [0]]))
            starts = np.where(diff == 1)[0]
            ends = np.where(diff == -1)[0]
            for ss, ee in zip(starts, ends):
                refined.append([s + ss * res, s + ee * res])
        return np.asarray(refined).reshape(-1, 2)

    def double_check_speech_segments(self, boundaries, audio_file,
                                     speech_th=0.5):
        """Keep the segments (of at least 50 ms) whose mean posterior,
        the model run on the segment alone, exceeds ``speech_th``: one
        batch of one a segment."""
        audio = self._audio(audio_file)
        sr = self.hparams.sample_rate
        checked = []
        for s, e in boundaries:
            seg = audio[int(s * sr): int(e * sr)]
            if seg.shape[0] < int(0.05 * sr):
                continue
            prob = self.get_speech_prob_chunk(seg[None])
            if float(prob.mean()) > speech_th:
                checked.append([s, e])
        return np.asarray(checked).reshape(-1, 2)

    def get_speech_segments(
        self, audio_file, large_chunk_size=30, small_chunk_size=10,
        overlap_small_chunk=False, apply_energy_VAD=False, double_check=True,
        close_th=0.25, len_th=0.25, activation_th=0.5, deactivation_th=0.25,
        en_activation_th=0.5, en_deactivation_th=0.0, speech_th=0.5,
    ):
        """The whole pipeline, the audio read once: file -> (n, 2)
        ``[start, end]`` speech segments in seconds."""
        audio = self._audio(audio_file)
        prob = self.get_speech_prob_file(audio, large_chunk_size,
                                         small_chunk_size,
                                         overlap_small_chunk)
        prob_th = self.apply_threshold(prob, activation_th, deactivation_th)
        boundaries = self.get_boundaries(prob_th)
        if apply_energy_VAD:
            boundaries = self.energy_VAD(audio, boundaries, en_activation_th,
                                         en_deactivation_th)
        boundaries = self.merge_close_segments(boundaries, close_th)
        boundaries = self.remove_short_segments(boundaries, len_th)
        if double_check and len(boundaries):
            boundaries = self.double_check_speech_segments(boundaries, audio,
                                                           speech_th)
        return boundaries
