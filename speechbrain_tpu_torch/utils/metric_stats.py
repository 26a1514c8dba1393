"""Metric accumulation across batches (port of
``speechbrain_tpu/utils/metric_stats.py``): ``MetricStats``,
``ErrorRateStats`` (WER and CER), ``WeightedErrorRateStats``,
``BinaryMetricStats``, ``EER``, ``minDCF``, ``ClassificationStats``,
``MultiMetricStats`` and ``Accuracy``. Scores accumulate on the host;
a metric may return a tensor on any device, which is read once a batch.
"""

import numpy as np
import torch

from speechbrain_tpu_torch.dataio.dataio import merge_char, split_word
from speechbrain_tpu_torch.nnet.losses import compute_length_mask
from speechbrain_tpu_torch.utils.data_utils import undo_padding
from speechbrain_tpu_torch.utils.edit_distance import (
    wer_details_for_batch,
    wer_summary,
)


def _host(scores):
    if isinstance(scores, torch.Tensor):
        return scores.detach().cpu().numpy()
    return np.asarray(scores)


class MetricStats:
    """Accumulate a metric over batches and summarize.

    Arguments
    ---------
    metric : callable
        Computes per-example scores for a batch (any signature; forwarded).
    n_jobs : int
        Accepted for parity; evaluation here is vectorized, not forked.

    Example
    -------
    >>> stats = MetricStats(metric=lambda p, t: (p - t).abs().mean(dim=1))
    >>> stats.append(["u1", "u2"], torch.zeros(2, 4), torch.ones(2, 4))
    >>> stats.summarize("average")
    1.0
    """

    def __init__(self, metric, n_jobs=1, batch_eval=True):
        self.metric = metric
        self.batch_eval = batch_eval
        self.clear()

    def clear(self):
        self.scores = []
        self.ids = []
        self.summary = {}

    def append(self, ids, *args, **kwargs):
        self.ids.extend(ids)
        scores = self.metric(*args, **kwargs)
        scores = np.atleast_1d(_host(scores))
        self.scores.extend(scores.tolist())

    def summarize(self, field=None):
        scores = np.asarray(self.scores, dtype=np.float64)
        if len(scores) == 0:
            self.summary = {"average": 0.0, "min_score": 0.0, "max_score": 0.0}
        else:
            min_i = int(np.argmin(scores))
            max_i = int(np.argmax(scores))
            self.summary = {
                "average": float(np.mean(scores)),
                "min_score": float(scores[min_i]),
                "min_id": self.ids[min_i],
                "max_score": float(scores[max_i]),
                "max_id": self.ids[max_i],
            }
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream, verbose=False):
        if not self.summary:
            self.summarize()
        message = f"Average score: {self.summary['average']}\n"
        message += f"Min error: {self.summary['min_score']} "
        message += f"id: {self.summary.get('min_id')}\n"
        message += f"Max error: {self.summary['max_score']} "
        message += f"id: {self.summary.get('max_id')}\n"
        filestream.write(message)
        if verbose:
            print(message)


class ErrorRateStats(MetricStats):
    """WER/CER accumulation (reference metric_stats.py:206).

    Example
    -------
    >>> stats = ErrorRateStats()
    >>> stats.append(["u1"], [[1, 2, 3]], [[1, 2, 4]])
    >>> stats.summarize("WER")
    33.33...
    """

    def __init__(self, merge_tokens=False, split_tokens=False, space_token="_",
                 keep_values=True, extract_concepts_values=False, tag_in="", tag_out=""):
        self.clear()
        self.merge_tokens = merge_tokens
        self.split_tokens = split_tokens
        self.space_token = space_token

    def clear(self):
        self.scores = []
        self.ids = []
        self.summary = {}

    def append(self, ids, predict, target, predict_len=None, target_len=None,
               ind2lab=None):
        """Accumulate a batch. predict/target: lists of token sequences, or
        padded arrays with relative lengths to undo."""
        self.ids.extend(ids)
        if predict_len is not None:
            predict = undo_padding(predict, predict_len)
        if target_len is not None:
            target = undo_padding(target, target_len)
        if ind2lab is not None:
            predict = ind2lab(predict)
            target = ind2lab(target)
        if self.merge_tokens:
            predict = merge_char(predict, space=self.space_token)
            target = merge_char(target, space=self.space_token)
        if self.split_tokens:
            predict = split_word(predict, space=self.space_token)
            target = split_word(target, space=self.space_token)
        scores = wer_details_for_batch(ids, target, predict, compute_alignments=True)
        self.scores.extend(scores)

    def summarize(self, field=None):
        self.summary = wer_summary(self.scores)
        # reference-compatible aliases
        self.summary["error_rate"] = self.summary["WER"]
        if field is not None:
            return self.summary[field]
        return self.summary

    def write_stats(self, filestream):
        """Kaldi-style detailed WER report (reference dataio/wer.py)."""
        if not self.summary:
            self.summarize()
        s = self.summary
        filestream.write(
            "%WER {WER:.2f} [ {num_edits} / {num_scored_tokens}, "
            "{insertions} ins, {deletions} del, {substitutions} sub ]\n".format(**s)
        )
        filestream.write(
            "%SER {SER:.2f} [ {num_erroneous_sents} / {num_scored_sents} ]\n".format(**s)
        )
        for d in self.scores:
            filestream.write(
                f"{d['key']}, %WER {d['WER']:.2f} [ {d['num_edits']} / "
                f"{d['num_ref_tokens']}, {d['insertions']} ins, "
                f"{d['deletions']} del, {d['substitutions']} sub ]\n"
            )
            if d["alignment"] is not None:
                ref = d["ref_tokens"]
                hyp = d["hyp_tokens"]
                ref_line, hyp_line, op_line = [], [], []
                for op, ri, hi in d["alignment"]:
                    r = str(ref[ri]) if ri is not None else "<eps>"
                    h = str(hyp[hi]) if hi is not None else "<eps>"
                    w = max(len(r), len(h), len(op))
                    ref_line.append(r.ljust(w))
                    hyp_line.append(h.ljust(w))
                    op_line.append(op.ljust(w))
                filestream.write(" ; ".join(ref_line) + "\n")
                filestream.write(" ; ".join(op_line) + "\n")
                filestream.write(" ; ".join(hyp_line) + "\n")


class WeightedErrorRateStats:
    """Wrap an ErrorRateStats with per-edit weights (e.g. semantic
    distances; reference metric_stats.py:381)."""

    def __init__(self, base_stats, cost_function, weight_name="weighted"):
        self.base_stats = base_stats
        self.cost_function = cost_function
        self.weight_name = weight_name
        self.summary = {}

    def summarize(self, field=None):
        base = self.base_stats.summarize()
        weighted_edits = 0.0
        total = 0
        for d in self.base_stats.scores:
            if not d["alignment"]:
                continue
            ref = d["ref_tokens"]
            hyp = d["hyp_tokens"]
            for op, ri, hi in d["alignment"]:
                r = ref[ri] if ri is not None else None
                h = hyp[hi] if hi is not None else None
                if op != "=":
                    weighted_edits += self.cost_function(op, r, h)
            total += d["num_ref_tokens"]
        self.summary = {
            f"{self.weight_name}_wer": 100.0 * weighted_edits / max(1, total),
            f"{self.weight_name}_insertions": None,
        }
        self.summary.update(base)
        if field is not None:
            return self.summary[field]
        return self.summary


class BinaryMetricStats(MetricStats):
    """Binary classification stats: F-score, precision/recall, EER-style
    threshold metrics (reference metric_stats.py:663)."""

    def __init__(self, positive_label=1):
        self.positive_label = positive_label
        self.clear()

    def clear(self):
        self.ids = []
        self.scores = []
        self.labels = []
        self.summary = {}

    def append(self, ids, scores, labels):
        self.ids.extend(ids)
        self.scores.extend(
            np.atleast_1d(_host(scores).astype(np.float64)).tolist())
        self.labels.extend(
            np.atleast_1d(_host(labels).astype(np.float64)).tolist())

    def summarize(self, field=None, threshold=None, max_samples=None, beta=1, eps=1e-8):
        scores = np.asarray(self.scores)
        labels = np.asarray(self.labels)
        if threshold is None:
            # EER threshold
            positive_scores = scores[labels == 1]
            negative_scores = scores[labels == 0]
            eer, threshold = EER(positive_scores, negative_scores)
        pred = (scores >= threshold).astype(np.float64)
        TP = float(np.sum((pred == 1) & (labels == 1)))
        TN = float(np.sum((pred == 0) & (labels == 0)))
        FP = float(np.sum((pred == 1) & (labels == 0)))
        FN = float(np.sum((pred == 0) & (labels == 1)))
        self.summary = {
            "TP": TP, "TN": TN, "FP": FP, "FN": FN,
            "FAR": FP / (FP + TN + eps),
            "FRR": FN / (TP + FN + eps),
            "DER": (FP + FN) / (TP + TN + eps),
            "threshold": float(threshold),
            "precision": TP / (TP + FP + eps),
            "recall": TP / (TP + FN + eps),
            "F-score": (1 + beta**2) * TP / ((1 + beta**2) * TP + beta**2 * FN + FP + eps),
            "MCC": (TP * TN - FP * FN)
            / (np.sqrt((TP + FP) * (TP + FN) * (TN + FP) * (TN + FN)) + eps),
        }
        if field is not None:
            return self.summary[field]
        return self.summary


def EER(positive_scores, negative_scores):
    """Equal error rate + threshold (reference metric_stats.py:809).

    Example
    -------
    >>> pos = np.asarray([0.6, 0.7, 0.8, 0.5])
    >>> neg = np.asarray([0.4, 0.3, 0.2, 0.1])
    >>> eer, th = EER(pos, neg)
    >>> eer
    0.0
    """
    positive_scores = np.asarray(positive_scores, np.float64)
    negative_scores = np.asarray(negative_scores, np.float64)
    thresholds = np.sort(np.unique(np.concatenate([positive_scores, negative_scores])))
    # interpolate between candidate thresholds for a finer sweep
    mids = (thresholds[:-1] + thresholds[1:]) / 2
    thresholds = np.sort(np.concatenate([thresholds, mids]))
    FRR = np.array([np.mean(positive_scores < t) for t in thresholds])
    FAR = np.array([np.mean(negative_scores >= t) for t in thresholds])
    idx = int(np.argmin(np.abs(FAR - FRR)))
    eer = float((FAR[idx] + FRR[idx]) / 2)
    return eer, float(thresholds[idx])


def minDCF(positive_scores, negative_scores, c_miss=1.0, c_fa=1.0, p_target=0.01):
    """Minimum detection cost function (reference metric_stats.py:868)."""
    positive_scores = np.asarray(positive_scores, np.float64)
    negative_scores = np.asarray(negative_scores, np.float64)
    thresholds = np.sort(np.unique(np.concatenate([positive_scores, negative_scores])))
    p_miss = np.array([np.mean(positive_scores < t) for t in thresholds])
    p_fa = np.array([np.mean(negative_scores >= t) for t in thresholds])
    c_det = c_miss * p_miss * p_target + c_fa * p_fa * (1 - p_target)
    c_def = min(c_miss * p_target, c_fa * (1 - p_target))
    idx = int(np.argmin(c_det))
    return float(c_det[idx] / c_def), float(thresholds[idx])


class ClassificationStats(MetricStats):
    """Per-class and confusion statistics for classification tasks
    (reference metric_stats.py:940)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.ids = []
        self.predictions = []
        self.targets = []
        self.categories = []
        self.summary = {}

    def append(self, ids, predictions, targets, categories=None):
        self.ids.extend(ids)
        self.predictions.extend(list(predictions))
        self.targets.extend(list(targets))
        if categories is not None:
            self.categories.extend(list(categories))

    def summarize(self, field=None):
        preds = self.predictions
        targets = self.targets
        correct = sum(1 for p, t in zip(preds, targets) if p == t)
        total = max(1, len(targets))
        self.summary = {
            "accuracy": correct / total,
            "classwise_stats": self._classwise(),
        }
        if field is not None:
            return self.summary[field]
        return self.summary

    def _classwise(self):
        stats = {}
        for p, t in zip(self.predictions, self.targets):
            entry = stats.setdefault(t, {"count": 0, "correct": 0})
            entry["count"] += 1
            entry["correct"] += int(p == t)
        for key, entry in stats.items():
            entry["accuracy"] = entry["correct"] / max(1, entry["count"])
        return stats

    def write_stats(self, filestream):
        if not self.summary:
            self.summarize()
        filestream.write(f"Overall accuracy: {self.summary['accuracy']:.2%}\n")
        filestream.write("Class-wise accuracy:\n")
        for key, entry in sorted(self.summary["classwise_stats"].items(), key=str):
            filestream.write(
                f"  {key}: {entry['correct']} / {entry['count']} "
                f"({entry['accuracy']:.2%})\n"
            )


class MultiMetricStats:
    """Evaluate a function returning a dict of metrics, tracking each
    (reference metric_stats.py:1246)."""

    def __init__(self, metric, n_jobs=1, batch_eval=True):
        self.metric = metric
        self.stats = {}

    def append(self, ids, *args, **kwargs):
        values = self.metric(*args, **kwargs)
        for key, value in values.items():
            if key not in self.stats:
                self.stats[key] = MetricStats(metric=lambda *a, **k: None)
                self.stats[key].clear()
            self.stats[key].ids.extend(ids)
            arr = np.atleast_1d(_host(value))
            self.stats[key].scores.extend(arr.tolist())

    def summarize(self, field=None):
        out = {key: stat.summarize(field) for key, stat in self.stats.items()}
        return out


class Accuracy:
    """Running (masked) accuracy of log-probability predictions.

    Example
    -------
    >>> acc = Accuracy()
    >>> acc.append(torch.log_softmax(torch.eye(3)[None], -1),
    ...            torch.tensor([[0, 1, 0]]), torch.tensor([2 / 3]))
    >>> acc.summarize()
    1.0
    """

    def __init__(self):
        self.correct = 0.0
        self.total = 0.0

    def append(self, log_probabilities, targets, length=None):
        hyps = log_probabilities.argmax(dim=-1)
        mask = compute_length_mask(targets.float(), length)
        self.correct += float(((hyps == targets) * mask).sum())
        self.total += float(mask.sum())

    def summarize(self):
        return self.correct / max(1.0, self.total)
