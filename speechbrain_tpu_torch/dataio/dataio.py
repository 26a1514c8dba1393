"""Manifests, audio files and token sequences (port of
``load_data_json``, ``load_data_csv``, ``read_audio``, ``read_audio_info``,
``write_audio``, ``merge_char`` and ``split_word`` from
``speechbrain_tpu/dataio/dataio.py``).

Audio is PCM WAV through the standard library's ``wave`` module: 8-bit
unsigned, 16- and 32-bit signed samples, scaled as soundfile scales them
(16-bit by 1/32768), multi-channel audio averaged to mono.
"""

import csv
import json
import re
import wave

import numpy as np


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


_PCM = {1: (np.uint8, 128.0), 2: (np.int16, 32768.0),
        4: (np.int32, 2147483648.0)}


def read_audio_info(path):
    """``(num_frames, sample_rate, num_channels)`` of a WAV file, from its
    header."""
    with wave.open(str(path), "rb") as w:
        return w.getnframes(), w.getframerate(), w.getnchannels()


def read_audio(waveforms_obj):
    """Read a PCM WAV file as float32 numpy, averaged to mono. Takes a
    path, or ``{"file": path, "start": sample, "stop": sample}``."""
    if isinstance(waveforms_obj, str):
        path, start, stop = waveforms_obj, 0, None
    else:
        path = waveforms_obj["file"]
        start = int(waveforms_obj.get("start", 0))
        stop = waveforms_obj.get("stop")
        stop = int(stop) if stop is not None else None
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        stop = n if stop is None else min(stop, n)
        w.setpos(start)
        raw = w.readframes(max(0, stop - start))
    if width not in _PCM:
        raise ValueError(f"{path}: {8 * width}-bit PCM is not read")
    dtype, scale = _PCM[width]
    data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    if width == 1:
        data -= 128.0
    data /= scale
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=-1)
    return data


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
