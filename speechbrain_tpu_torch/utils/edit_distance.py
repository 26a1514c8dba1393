"""Edit distance and accumulatable WER statistics (port of
``speechbrain_tpu/utils/edit_distance.py``): Levenshtein statistics with
insertion, deletion and substitution counts, alignments and per-utterance
details on the host. ``accumulatable_wer_stats`` counts every batch with
the native C++ core (``editdist_native.edit_ops_batch``); the pure-Python
DP (``op_table``, ``count_ops``) serves the alignments and the
per-utterance details.
"""

import collections

import numpy as np

from speechbrain_tpu_torch.utils.editdist_native import edit_ops_batch

EDIT_SYMBOLS = {
    "eq": "=",
    "ins": "I",
    "del": "D",
    "sub": "S",
}


def _batch_to_list(batch):
    out = []
    for seq in batch:
        out.append(list(seq))
    return out


def accumulatable_wer_stats(refs, hyps, stats=None):
    """Update running WER stats with a batch of (refs, hyps) token lists.

    Returns a dict with num_ref_tokens, WER, insertions, deletions,
    substitutions, num_edits.

    Example
    -------
    >>> refs = [[1, 2, 3], [4, 5]]
    >>> hyps = [[1, 2, 4], [4, 5, 6]]
    >>> stats = accumulatable_wer_stats(refs, hyps)
    >>> round(stats["WER"], 1)
    40.0
    """
    updated_stats = collections.Counter(stats) if stats else collections.Counter()
    # derived fields must not double-accumulate
    for derived in ("WER", "num_edits"):
        updated_stats.pop(derived, None)
    refs = _batch_to_list(refs)
    hyps = _batch_to_list(hyps)
    ops = edit_ops_batch(refs, hyps).sum(axis=0)
    updated_stats.update({
        "insertions": int(ops[0]),
        "deletions": int(ops[1]),
        "substitutions": int(ops[2]),
        "num_ref_tokens": sum(len(r) for r in refs),
    })
    updated = dict(updated_stats)
    for key in ("insertions", "deletions", "substitutions"):
        updated.setdefault(key, 0)
    n = max(updated.get("num_ref_tokens", 0), 1)
    updated["num_edits"] = (
        updated.get("insertions", 0)
        + updated.get("deletions", 0)
        + updated.get("substitutions", 0)
    )
    updated["WER"] = 100.0 * updated["num_edits"] / n
    return updated


def op_table(a, b):
    """Dynamic-programming table of edit ops turning ``a`` (ref) into
    ``b`` (hyp); returns a list-of-lists of EDIT_SYMBOLS values
    (reference edit_distance.py:146)."""
    a = list(a)
    b = list(b)
    table = [[EDIT_SYMBOLS["eq"] for _ in range(len(b) + 1)] for _ in range(len(a) + 1)]
    costs = np.zeros((len(a) + 1, len(b) + 1), dtype=np.int32)
    for i in range(len(a) + 1):
        costs[i][0] = i
        table[i][0] = EDIT_SYMBOLS["del"]
    for j in range(len(b) + 1):
        costs[0][j] = j
        table[0][j] = EDIT_SYMBOLS["ins"]
    table[0][0] = EDIT_SYMBOLS["eq"]
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            if a[i - 1] == b[j - 1]:
                costs[i][j] = costs[i - 1][j - 1]
                table[i][j] = EDIT_SYMBOLS["eq"]
            else:
                ins = costs[i][j - 1] + 1
                dele = costs[i - 1][j] + 1
                sub = costs[i - 1][j - 1] + 1
                best = min(ins, dele, sub)
                costs[i][j] = best
                if best == sub:
                    table[i][j] = EDIT_SYMBOLS["sub"]
                elif best == ins:
                    table[i][j] = EDIT_SYMBOLS["ins"]
                else:
                    table[i][j] = EDIT_SYMBOLS["del"]
    return table


def count_ops(table):
    """Count edits from an op table by walking back from the corner
    (reference edit_distance.py:speed-optimized variant)."""
    edits = collections.Counter()
    i = len(table) - 1
    j = len(table[0]) - 1
    while not (i == 0 and j == 0):
        if i == 0:
            edits["insertions"] += 1
            j -= 1
        elif j == 0:
            edits["deletions"] += 1
            i -= 1
        else:
            sym = table[i][j]
            if sym == EDIT_SYMBOLS["ins"]:
                edits["insertions"] += 1
                j -= 1
            elif sym == EDIT_SYMBOLS["del"]:
                edits["deletions"] += 1
                i -= 1
            else:
                if sym == EDIT_SYMBOLS["sub"]:
                    edits["substitutions"] += 1
                i -= 1
                j -= 1
    return edits


def alignment(table):
    """Extract alignment [(op, ref_idx|None, hyp_idx|None)] from an op
    table (reference edit_distance.py:240)."""
    i = len(table) - 1
    j = len(table[0]) - 1
    out = []
    while not (i == 0 and j == 0):
        if i == 0:
            out.append((EDIT_SYMBOLS["ins"], None, j - 1))
            j -= 1
        elif j == 0:
            out.append((EDIT_SYMBOLS["del"], i - 1, None))
            i -= 1
        else:
            sym = table[i][j]
            if sym == EDIT_SYMBOLS["ins"]:
                out.append((sym, None, j - 1))
                j -= 1
            elif sym == EDIT_SYMBOLS["del"]:
                out.append((sym, i - 1, None))
                i -= 1
            else:
                out.append((sym, i - 1, j - 1))
                i -= 1
                j -= 1
    out.reverse()
    return out


def wer_details_for_batch(ids, refs, hyps, compute_alignments=False):
    """Per-utterance WER details (reference edit_distance.py:429)."""
    details = []
    for utt_id, ref, hyp in zip(ids, refs, hyps):
        ref = list(ref)
        hyp = list(hyp)
        table = op_table(ref, hyp)
        ops = count_ops(table)
        num_edits = sum(ops.values())
        details.append(
            {
                "key": utt_id,
                "scored": True,
                "hyp_absent": hyp is None,
                "hyp_empty": len(hyp) == 0,
                "num_edits": num_edits,
                "num_ref_tokens": len(ref),
                "WER": 100.0 * num_edits / max(len(ref), 1),
                "insertions": ops["insertions"],
                "deletions": ops["deletions"],
                "substitutions": ops["substitutions"],
                "alignment": alignment(table) if compute_alignments else None,
                "ref_tokens": ref if compute_alignments else None,
                "hyp_tokens": hyp if compute_alignments else None,
            }
        )
    return details


def wer_summary(details_by_utterance):
    """Aggregate per-utterance details into corpus-level stats
    (reference edit_distance.py:635)."""
    total = {
        "num_edits": 0,
        "num_scored_tokens": 0,
        "num_erroneous_sents": 0,
        "num_scored_sents": 0,
        "num_absent_sents": 0,
        "num_ref_sents": len(details_by_utterance),
        "insertions": 0,
        "deletions": 0,
        "substitutions": 0,
    }
    for d in details_by_utterance:
        if d["hyp_absent"]:
            total["num_absent_sents"] += 1
        if not d["scored"]:
            continue
        total["num_scored_sents"] += 1
        total["num_scored_tokens"] += d["num_ref_tokens"]
        total["num_edits"] += d["num_edits"]
        total["insertions"] += d["insertions"]
        total["deletions"] += d["deletions"]
        total["substitutions"] += d["substitutions"]
        if d["num_edits"] > 0:
            total["num_erroneous_sents"] += 1
    total["WER"] = 100.0 * total["num_edits"] / max(1, total["num_scored_tokens"])
    total["SER"] = 100.0 * total["num_erroneous_sents"] / max(
        1, total["num_scored_sents"]
    )
    return total


def wer_details_by_speaker(details_by_utterance, utt2spk):
    """Group WER details per speaker (reference edit_distance.py)."""
    by_spk = {}
    for d in details_by_utterance:
        spk = utt2spk.get(d["key"], "unknown")
        entry = by_spk.setdefault(
            spk,
            collections.Counter(
                {"num_edits": 0, "num_scored_tokens": 0, "num_scored_sents": 0}
            ),
        )
        if d["scored"]:
            entry["num_scored_sents"] += 1
            entry["num_scored_tokens"] += d["num_ref_tokens"]
            entry["num_edits"] += d["num_edits"]
    out = {}
    for spk, entry in by_spk.items():
        stats = dict(entry)
        stats["WER"] = 100.0 * stats["num_edits"] / max(1, stats["num_scored_tokens"])
        out[spk] = stats
    return out


def top_wer_utts(details_by_utterance, top_k=20):
    """Worst utterances by WER."""
    scored = [d for d in details_by_utterance if d["scored"]]
    return sorted(scored, key=lambda d: d["WER"], reverse=True)[:top_k]
