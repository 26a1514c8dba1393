"""Emotion diarization error rate (port of ``speechbrain_tpu/utils/EDER.py``,
host Python): the share of ``stride``-second frames whose hypothesised
emotion differs from the reference's, neutral (``"n"``) where no segment
covers a frame."""

import numpy as np


def EDER(prediction, id_, duration, emotion, window_length=0.02, stride=0.02):
    """Emotion diarization error rate of one utterance.

    Arguments
    ---------
    prediction : list of {"start", "end", "emotion"} hypothesis segments
    id_ : str (unused; the reference's signature)
    duration : float, seconds
    emotion : list of {"start", "end", "emo"} reference segments
    """
    n = int(np.ceil(duration / stride)) + 1

    def frame_labels(segments, key):
        labs = np.full(n, "n", dtype=object)
        for seg in segments:
            lo = int(np.floor(seg["start"] / stride))
            hi = int(np.ceil(seg["end"] / stride))
            labs[max(lo, 0): min(hi, n)] = seg[key]
        return labs

    ref = frame_labels(emotion, "emo")
    hyp = frame_labels(prediction, "emotion")
    return float(np.mean(ref != hyp))
