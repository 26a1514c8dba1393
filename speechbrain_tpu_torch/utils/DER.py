"""Diarization error rate (port of ``speechbrain_tpu/utils/DER.py``, host
Python): reference and hypothesis ``(start, end, speaker)`` lists scored
on a grid of ``step`` seconds, frames within ``collar`` of a reference
boundary left out, speakers mapped one to one greedily by overlap."""

import numpy as np


def DER(ref_segments, hyp_segments, collar=0.25, step=0.01):
    """Diarization error rate: (missed + false alarm + confused speaker
    frames) over the reference's speaker frames.

    Example
    -------
    >>> ref = [(0.0, 1.0, "A"), (1.0, 2.0, "B")]
    >>> round(DER(ref, ref, collar=0.0), 3)
    0.0
    >>> hyp = [(0.0, 2.0, "A")]
    >>> 0.4 < DER(ref, hyp, collar=0.0) < 0.6
    True
    """
    end = max(
        max((s[1] for s in ref_segments), default=0.0),
        max((s[1] for s in hyp_segments), default=0.0),
    )
    n = int(np.ceil(end / step)) + 1

    def labels_at(segments):
        labs = [set() for _ in range(n)]
        for s, e, spk in segments:
            lo, hi = int(np.floor(s / step)), int(np.ceil(e / step))
            for i in range(lo, min(hi, n)):
                labs[i].add(spk)
        return labs

    ref = labels_at(ref_segments)
    hyp = labels_at(hyp_segments)
    keep = np.ones(n, bool)
    if collar > 0:
        for s, e, _ in ref_segments:
            for b in (s, e):
                lo = int(np.floor((b - collar) / step))
                hi = int(np.ceil((b + collar) / step))
                keep[max(lo, 0): min(hi, n)] = False
    overlap = {}
    for i in range(n):
        if not keep[i]:
            continue
        for r in ref[i]:
            for h in hyp[i]:
                overlap[(r, h)] = overlap.get((r, h), 0) + 1
    mapping, used_h = {}, set()
    for (r, h), _cnt in sorted(overlap.items(), key=lambda kv: -kv[1]):
        if r not in mapping and h not in used_h:
            mapping[r] = h
            used_h.add(h)
    total_ref = 0
    errors = 0.0
    for i in range(n):
        if not keep[i]:
            continue
        nref, nhyp = len(ref[i]), len(hyp[i])
        correct = sum(1 for r in ref[i] if mapping.get(r) in hyp[i])
        total_ref += nref
        errors += max(nref, nhyp) - correct
    return errors / max(total_ref, 1)
