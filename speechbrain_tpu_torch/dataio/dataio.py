"""Manifests, audio files and token sequences (port of
``load_data_json``, ``load_data_csv``, ``read_audio``, ``read_audio_info``,
``read_audio_multichannel``, ``write_audio``, ``merge_char``,
``split_word``, ``length_to_mask`` and ``relative_length_to_mask`` from
``speechbrain_tpu/dataio/dataio.py``).

Audio is WAV read by the native decoder (``io/native.py``: 8-bit
unsigned, 16-, 24- and 32-bit signed PCM and IEEE float32, scaled as
soundfile scales them, 16-bit by 1/32768), multi-channel audio averaged to
mono by ``read_audio``; another format raises. ``write_audio`` writes
16-bit PCM through the standard library's ``wave`` module.
"""

import csv
import json
import os
import re
import wave

import numpy as np
import torch

from speechbrain_tpu_torch.io.native import read_wav, read_wav_mono, wav_info


def load_data_json(json_path, replacements=None):
    """Load a JSON manifest ``{id: {key: value}}``, replacing ``$name``
    in every string by ``replacements[name]``.

    Example
    -------
    >>> import tempfile
    >>> with tempfile.NamedTemporaryFile("w", suffix=".json",
    ...                                  delete=False) as f:
    ...     _ = f.write('{"utt1": {"wav": "$root/a.wav"}}')
    >>> load_data_json(f.name, {"root": "/data"})["utt1"]["wav"]
    '/data/a.wav'
    """
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    if not replacements:
        return data
    pattern = re.compile(r"\$([\w]+)")

    def walk(obj):
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        if isinstance(obj, str):
            return pattern.sub(
                lambda m: str(replacements.get(m.group(1), m.group(0))), obj
            )
        return obj

    return walk(data)


def load_data_csv(csv_path, replacements=None):
    """Load a CSV manifest with an ``ID`` column into ``{id: {key:
    value}}``, replacing ``$name`` in every field by
    ``replacements[name]``; a ``duration`` column becomes a float."""
    replacements = replacements or {}
    pattern = re.compile(r"\$([\w]+)")
    result = {}
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f, skipinitialspace=True):
            try:
                data_id = row.pop("ID")
            except KeyError:
                raise KeyError("CSV has to have an 'ID' field, with unique "
                               "ids for all data points") from None
            if data_id in result:
                raise ValueError(f"Duplicate id: {data_id}")
            for key, value in row.items():
                if isinstance(value, str):
                    row[key] = pattern.sub(
                        lambda m: str(replacements.get(m.group(1),
                                                       m.group(0))), value)
            if "duration" in row:
                row["duration"] = float(row["duration"])
            result[data_id] = row
    return result


def _wav_path(path):
    """``path`` as a string, refusing any file that is not a WAV file:
    the port decodes WAV only (``io/native.py``), and has no reader for
    other formats yet."""
    path = str(path)
    suffix = os.path.splitext(path)[1].lower()
    if suffix != ".wav":
        raise ValueError(
            f"{path}: {suffix[1:] or 'extension-less'} audio is not read; "
            f"the port reads WAV files only"
        )
    return path


def _segment(waveforms_obj):
    """(path, start, stop) of a path or a ``{"file", "start", "stop"}``
    spec."""
    if isinstance(waveforms_obj, (str, os.PathLike)):
        return _wav_path(waveforms_obj), 0, None
    stop = waveforms_obj.get("stop")
    return (_wav_path(waveforms_obj["file"]),
            int(waveforms_obj.get("start", 0)),
            None if stop is None else int(stop))


def read_audio_info(path):
    """``(num_frames, sample_rate, num_channels)`` of a WAV file, from its
    header."""
    return wav_info(_wav_path(path))


def read_audio(waveforms_obj):
    """Read a WAV file (PCM 8/16/24/32-bit or IEEE float32) as float32
    numpy, averaged to mono, by the native decoder. Takes a path, or
    ``{"file": path, "start": sample, "stop": sample}``."""
    path, start, stop = _segment(waveforms_obj)
    return read_wav_mono(path, start, stop)[0]


def read_audio_multichannel(waveforms_obj):
    """Read WAV audio keeping its channels: float32 ``(time, channels)``.
    Takes a path, or ``{"file": path}`` or ``{"files": [paths]}`` (the
    files' channels side by side) with optional ``start``/``stop``."""
    if isinstance(waveforms_obj, (str, os.PathLike)):
        files, start, stop = [waveforms_obj], 0, None
    else:
        files = waveforms_obj.get("files") or [waveforms_obj["file"]]
        stop = waveforms_obj.get("stop")
        start = int(waveforms_obj.get("start", 0))
        stop = None if stop is None else int(stop)
    return np.concatenate(
        [read_wav(_wav_path(f), start, stop)[0] for f in files], axis=-1
    )


def write_audio(filepath, audio, samplerate):
    """Write float audio, (time,) or (time, channels) in [-1, 1], as
    16-bit PCM WAV."""
    pcm = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(str(filepath), "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(samplerate)
        w.writeframes(pcm.tobytes())


def merge_char(sequences, space="_"):
    """Merge characters into words at the space symbol.

    Example
    -------
    >>> merge_char([["a", "b", "_", "c"]])
    [['ab', 'c']]
    """
    return [[w for w in "".join(seq).split(space) if w]
            for seq in sequences]


def split_word(sequences, space="_"):
    """Split words into characters, the space symbol between words.

    Example
    -------
    >>> split_word([["ab", "c"]])
    [['a', 'b', '_', 'c']]
    """
    results = []
    for seq in sequences:
        chars = []
        for i, word in enumerate(seq):
            if i > 0:
                chars.append(space)
            chars.extend(word)
        results.append(chars)
    return results


def length_to_mask(length, max_len=None, dtype=None, device=None):
    """Absolute lengths ``(B,)`` to a boolean mask ``(B, max_len)``, True
    inside each length; ``max_len`` defaults to the largest length.

    Example
    -------
    >>> length_to_mask(torch.tensor([2, 3]), max_len=4).int().tolist()
    [[1, 1, 0, 0], [1, 1, 1, 0]]
    """
    length = torch.as_tensor(length, device=device)
    if max_len is None:
        max_len = int(length.max())
    positions = torch.arange(max_len, device=length.device)[None, :]
    mask = positions < length[:, None]
    return mask if dtype is None else mask.to(dtype)


def relative_length_to_mask(rel_length, max_len, dtype=None, device=None):
    """A mask from relative lengths in [0, 1] of ``max_len`` frames:
    ``round(rel_length * max_len)`` frames each, rounding half to even as
    ``jnp.round`` does.

    Example
    -------
    >>> relative_length_to_mask(torch.tensor([0.625, 1.0]), 4).int().tolist()
    [[1, 1, 0, 0], [1, 1, 1, 1]]
    """
    rel_length = torch.as_tensor(rel_length, dtype=torch.float32,
                                 device=device)
    lengths = torch.round(rel_length * max_len).to(torch.int32)
    return length_to_mask(lengths, max_len=max_len, dtype=dtype)
