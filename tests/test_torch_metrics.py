"""The port's WER and metrics against the JAX package's on seeded inputs:
``utils/edit_distance.py`` (``accumulatable_wer_stats``, ``op_table``,
``count_ops``, ``alignment``, ``wer_details_for_batch``, ``wer_summary``,
``wer_details_by_speaker``, ``top_wer_utts``), ``utils/metric_stats.py``
(``ErrorRateStats`` with padded batches, token merging and splitting, its
report; ``MetricStats``, ``BinaryMetricStats``, ``EER``, ``minDCF``,
``ClassificationStats``, ``MultiMetricStats``, ``WeightedErrorRateStats``,
``Accuracy``), ``decoders/ctc.py`` ``ctc_greedy_decode`` and the helpers
``undo_padding``, ``merge_char`` and ``split_word``.

Counts, alignments, token lists and reports are equal exactly; rates
(float64 on both sides) within 1e-12. The JAX package's
``accumulatable_wer_stats`` takes its native edit-distance path where the
library builds, the port its one pure-Python path: their counts must
agree."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechbrain_tpu.dataio.dataio import merge_char as jax_merge_char
from speechbrain_tpu.dataio.dataio import split_word as jax_split_word
from speechbrain_tpu.decoders.ctc import ctc_greedy_decode as jax_greedy
from speechbrain_tpu.utils import edit_distance as jax_ed
from speechbrain_tpu.utils import metric_stats as jax_ms
from speechbrain_tpu.utils.data_utils import undo_padding as jax_undo
from speechbrain_tpu_torch.dataio.dataio import merge_char, split_word
from speechbrain_tpu_torch.decoders.ctc import (
    ctc_greedy_decode,
    filter_ctc_output,
)
from speechbrain_tpu_torch.utils import edit_distance as ed
from speechbrain_tpu_torch.utils import metric_stats as ms
from speechbrain_tpu_torch.utils.data_utils import undo_padding

RATE_TOL = 1e-12


def _token_lists(rng, n, vocab=6, max_len=9):
    """Random token lists over a small vocabulary (so that many tokens
    match), some of them empty."""
    return [rng.integers(0, vocab, rng.integers(0, max_len)).tolist()
            for _ in range(n)]


def _pairs(seed, n=40):
    rng = np.random.default_rng(seed)
    refs = _token_lists(rng, n)
    hyps = [r if rng.random() < 0.2 else h
            for r, h in zip(refs, _token_lists(rng, n))]
    refs[0], hyps[1] = [], []  # an empty reference, an empty hypothesis
    return refs, hyps


def _close(a, b):
    """Equal dicts, rates within RATE_TOL."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) or isinstance(b[k], float):
            assert abs(a[k] - b[k]) <= RATE_TOL, k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accumulatable_wer_stats(seed):
    refs, hyps = _pairs(seed)
    stats = jstats = None
    for lo in range(0, len(refs), 7):  # accumulated over batches
        stats = ed.accumulatable_wer_stats(refs[lo:lo + 7], hyps[lo:lo + 7],
                                           stats)
        jstats = jax_ed.accumulatable_wer_stats(refs[lo:lo + 7],
                                                hyps[lo:lo + 7], jstats)
        _close(stats, jstats)
    assert stats["num_ref_tokens"] == sum(len(r) for r in refs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_tables_alignments_and_details(seed):
    refs, hyps = _pairs(seed)
    ids = [f"utt{i}" for i in range(len(refs))]
    for r, h in zip(refs, hyps):
        table = ed.op_table(r, h)
        assert table == jax_ed.op_table(r, h)
        assert ed.count_ops(table) == jax_ed.count_ops(table)
        assert ed.alignment(table) == jax_ed.alignment(table)
    for align in (False, True):
        details = ed.wer_details_for_batch(ids, refs, hyps, align)
        jdetails = jax_ed.wer_details_for_batch(ids, refs, hyps, align)
        for d, jd in zip(details, jdetails):
            _close(d, jd)
    _close(ed.wer_summary(details), jax_ed.wer_summary(jdetails))
    utt2spk = {u: f"spk{i % 3}" for i, u in enumerate(ids[:-2])}
    by_spk = ed.wer_details_by_speaker(details, utt2spk)
    jby_spk = jax_ed.wer_details_by_speaker(jdetails, utt2spk)
    assert by_spk.keys() == jby_spk.keys()
    for spk in by_spk:
        _close(by_spk[spk], jby_spk[spk])
    assert [d["key"] for d in ed.top_wer_utts(details, 5)] == \
        [d["key"] for d in jax_ed.top_wer_utts(jdetails, 5)]


def _padded(lists, rng):
    """A padded batch of token lists (with one extra column) and their
    relative lengths."""
    width = max(len(x) for x in lists) + 1
    arr = np.zeros((len(lists), width), np.int64)
    for i, x in enumerate(lists):
        arr[i, :len(x)] = x
        arr[i, len(x):] = rng.integers(0, 6, width - len(x))
    return arr, np.asarray([len(x) / width for x in lists])


@pytest.mark.parametrize("seed", [0, 1])
def test_error_rate_stats_on_padded_batches(seed):
    rng = np.random.default_rng(seed)
    refs, hyps = _pairs(seed, n=12)
    stats, jstats = ms.ErrorRateStats(), jax_ms.ErrorRateStats()
    for lo in (0, 6):
        ids = [f"u{lo + i}" for i in range(6)]
        pa, pl = _padded(hyps[lo:lo + 6], rng)
        ta, tl = _padded(refs[lo:lo + 6], rng)
        stats.append(ids, torch.from_numpy(pa), torch.from_numpy(ta),
                     torch.from_numpy(pl), torch.from_numpy(tl))
        jstats.append(ids, pa, ta, pl, tl)
    _close(stats.summarize(), jstats.summarize())
    assert stats.summarize("WER") == stats.summarize("error_rate")
    out, jout = io.StringIO(), io.StringIO()
    stats.write_stats(out)
    jstats.write_stats(jout)
    assert out.getvalue() == jout.getvalue()


def test_error_rate_stats_on_characters():
    """CER with merged and with split tokens, and a label mapping."""
    refs = [list("the_cat_sat"), list("a_dog"), []]
    hyps = [list("the_bat_sat_"), list("dog"), list("x")]
    for kw in ({"merge_tokens": True}, {"split_tokens": True},
               {"merge_tokens": True, "split_tokens": True}):
        stats, jstats = ms.ErrorRateStats(**kw), jax_ms.ErrorRateStats(**kw)
        words_r = merge_char(refs) if kw.get("split_tokens") else refs
        words_h = merge_char(hyps) if kw.get("split_tokens") else hyps
        stats.append(["a", "b", "c"], words_h, words_r)
        jstats.append(["a", "b", "c"], words_h, words_r)
        _close(stats.summarize(), jstats.summarize())
    upper = lambda batch: [[t.upper() for t in seq] for seq in batch]  # noqa
    stats, jstats = ms.ErrorRateStats(), jax_ms.ErrorRateStats()
    stats.append(["a", "b", "c"], hyps, refs, ind2lab=upper)
    jstats.append(["a", "b", "c"], hyps, refs, ind2lab=upper)
    _close(stats.summarize(), jstats.summarize())


def test_merge_char_split_word_undo_padding():
    rng = np.random.default_rng(3)
    seqs = [list("ab_c__de_"), [], list("_x")]
    assert merge_char(seqs) == jax_merge_char(seqs)
    words = merge_char(seqs)
    assert split_word(words) == jax_split_word(words)
    assert split_word(words, space="|") == jax_split_word(words, space="|")
    arr = rng.integers(0, 9, (4, 7))
    lens = np.asarray([1.0, 0.5, 0.0, 3 / 7])
    assert undo_padding(torch.from_numpy(arr), torch.from_numpy(lens)) == \
        jax_undo(arr, lens) == undo_padding(arr, lens)


@pytest.mark.parametrize("blank_id", [0, -1, 3])
def test_ctc_greedy_decode(blank_id):
    """Seeded log-probabilities, with repeats made likely by a sticky
    argmax, at relative lengths."""
    rng = np.random.default_rng(4)
    B, T, V = 5, 23, 6
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    logits[:, 1::2] = logits[:, ::2][:, :T // 2]  # runs of one symbol
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = np.asarray([1.0, 0.5, 17 / 23, 1 / 23, 0.0], np.float32)
    got = ctc_greedy_decode(torch.from_numpy(logp), torch.from_numpy(lens),
                            blank_id=blank_id)
    want = jax_greedy(jnp.asarray(logp), jnp.asarray(lens),
                      blank_id=blank_id)
    assert got == want
    assert any(len(h) > 1 for h in got) and got[-1] == []
    assert filter_ctc_output([0, 1, 1, 0, 2, 2], 0) == [1, 2]
    with pytest.raises(ValueError):
        filter_ctc_output((0, 1))


def test_metric_stats_and_multi_metric_stats():
    rng = np.random.default_rng(5)
    p, t = rng.standard_normal((2, 6, 4)).astype(np.float32)

    def l1(a, b):
        return (a - b).abs().mean(dim=1)

    def jl1(a, b):
        return np.abs(a - b).mean(axis=1)

    stats, jstats = ms.MetricStats(l1), jax_ms.MetricStats(jl1)
    ids = [f"u{i}" for i in range(6)]
    stats.append(ids, torch.from_numpy(p), torch.from_numpy(t))
    jstats.append(ids, p, t)
    _close(stats.summarize(), jstats.summarize())
    out, jout = io.StringIO(), io.StringIO()
    stats.write_stats(out)
    jstats.write_stats(jout)
    assert out.getvalue() == jout.getvalue()
    empty = ms.MetricStats(l1).summarize()
    assert empty == jax_ms.MetricStats(jl1).summarize()

    multi = ms.MultiMetricStats(lambda a, b: {"l1": l1(a, b),
                                              "max": (a - b).amax(1)})
    jmulti = jax_ms.MultiMetricStats(lambda a, b: {"l1": jl1(a, b),
                                                   "max": (a - b).max(1)})
    multi.append(ids, torch.from_numpy(p), torch.from_numpy(t))
    jmulti.append(ids, p, t)
    got, want = multi.summarize(), jmulti.summarize()
    assert got.keys() == want.keys() == {"l1", "max"}
    for key in got:
        _close(got[key], want[key])


def test_binary_stats_eer_and_min_dcf():
    rng = np.random.default_rng(6)
    pos = rng.normal(1.0, 1.0, 50)
    neg = rng.normal(-1.0, 1.0, 70)
    assert ms.EER(pos, neg) == jax_ms.EER(pos, neg)
    assert ms.minDCF(pos, neg) == jax_ms.minDCF(pos, neg)
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(50), np.zeros(70)])
    ids = [f"u{i}" for i in range(120)]
    for threshold in (None, 0.25):
        stats, jstats = ms.BinaryMetricStats(), jax_ms.BinaryMetricStats()
        stats.append(ids, torch.from_numpy(scores), torch.from_numpy(labels))
        jstats.append(ids, scores, labels)
        _close(stats.summarize(threshold=threshold),
               jstats.summarize(threshold=threshold))


def test_classification_stats_and_accuracy():
    rng = np.random.default_rng(7)
    preds = rng.integers(0, 4, 30).tolist()
    targets = rng.integers(0, 4, 30).tolist()
    stats, jstats = ms.ClassificationStats(), jax_ms.ClassificationStats()
    stats.append(list(range(30)), preds, targets)
    jstats.append(list(range(30)), preds, targets)
    assert stats.summarize() == jstats.summarize()
    out, jout = io.StringIO(), io.StringIO()
    stats.write_stats(out)
    jstats.write_stats(jout)
    assert out.getvalue() == jout.getvalue()

    logp = rng.standard_normal((3, 8, 5)).astype(np.float32)
    tgt = rng.integers(0, 5, (3, 8))
    lens = np.asarray([1.0, 0.5, 0.25], np.float32)
    acc, jacc = ms.Accuracy(), jax_ms.Accuracy()
    acc.append(torch.from_numpy(logp), torch.from_numpy(tgt),
               torch.from_numpy(lens))
    jacc.append(jnp.asarray(logp), jnp.asarray(tgt), jnp.asarray(lens))
    assert (acc.correct, acc.total) == (jacc.correct, jacc.total)
    assert acc.summarize() == jacc.summarize()


def test_weighted_error_rate_stats():
    refs, hyps = _pairs(8, n=10)
    ids = [f"u{i}" for i in range(10)]

    def cost(op, r, h):
        return 0.5 if op == "S" else 1.0

    base, jbase = ms.ErrorRateStats(), jax_ms.ErrorRateStats()
    base.append(ids, hyps, refs)
    jbase.append(ids, hyps, refs)
    w = ms.WeightedErrorRateStats(base, cost).summarize()
    jw = jax_ms.WeightedErrorRateStats(jbase, cost).summarize()
    _close(w, jw)
