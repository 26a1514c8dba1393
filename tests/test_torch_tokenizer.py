"""The port's tokenizer (``speechbrain_tpu_torch/tokenizers/SentencePiece.py``)
against the JAX package's, trained on the same small manifest in the
``bpe``, ``unigram`` and ``char`` modes: the ``.model.json`` bytes, the
pieces, ids and decodings, each side loading the other's model file, the
batch call's tasks and ``StreamingDetokenizer``. Everything is exact: the
results are strings and integers.

Unigram training orders its seed pieces through a ``set`` of strings, so
its result follows ``PYTHONHASHSEED``; the two sides are trained in this
one process, under one hash seed (``ROADMAP.md`` Queue C)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import csv
import json
import shutil

import numpy as np
import pytest
import torch

from speechbrain_tpu.tokenizers.SentencePiece import (
    SentencePiece as JaxSentencePiece,
)
from speechbrain_tpu.tokenizers.SentencePiece import (
    StreamingDetokenizer as JaxStreamingDetokenizer,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import (
    SentencePiece,
    StreamingDetokenizer,
)

WORDS = ("ALPHA BRAVO CHARLIE DELTA ECHO FOXTROT GOLF HOTEL INDIA JULIET "
         "KILO LIMA MIKE NOVEMBER OSCAR PAPA QUEBEC ROMEO SIERRA TANGO "
         "THE A OF TO AND IN THAT HE WAS IT").split()
MODES = {"bpe": 60, "unigram": 50, "char": 1}


def _sentences(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS),
                                                    rng.integers(2, 9)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    path = root / "train.json"
    with open(path, "w") as f:
        json.dump({f"u{i}": {"words": t, "wav": f"$root/u{i}.wav"}
                   for i, t in enumerate(_sentences(40, 0))}, f)
    return root, path


@pytest.fixture(scope="module", params=list(MODES))
def pair(request, manifest):
    """Both tokenizers trained from ``manifest`` in one mode."""
    root, path = manifest
    mode = request.param
    out = {}
    for name, cls in (("jax", JaxSentencePiece), ("torch", SentencePiece)):
        out[name] = cls(str(root / f"{name}_{mode}"), MODES[mode],
                        annotation_train=str(path), annotation_read="words",
                        model_type=mode, annotation_format="json")
    return mode, out["jax"], out["torch"]


TEXTS = _sentences(12, 1) + ["ALPHA", "ZULU WHISKEY", "alpha BRAVO", ""]


def test_model_files_are_byte_equal(pair):
    mode, j, t = pair
    assert t.model_path.endswith(f"{MODES[mode]}_{mode}.model.json")
    with open(j.model_path, "rb") as a, open(t.model_path, "rb") as b:
        assert a.read() == b.read()
    assert t.sp.vocab_size() == j.sp.vocab_size()
    assert [t.sp.id_to_piece(i) for i in range(t.sp.get_piece_size())] \
        == [j.sp.id_to_piece(i) for i in range(j.sp.get_piece_size())]


def test_pieces_ids_and_decodings_are_equal(pair):
    _, j, t = pair
    for text in TEXTS:
        assert t.sp.encode_as_pieces(text) == j.sp.encode_as_pieces(text)
        ids = t.sp.encode_as_ids(text)
        assert ids == j.sp.encode_as_ids(text)
        assert t.sp.decode_ids(ids) == j.sp.decode_ids(ids)
        assert t.decode_ids(ids) == j.decode_ids(ids)
        for piece in t.sp.encode_as_pieces(text) + ["<unk>", "missing"]:
            assert t.sp.piece_to_id(piece) == j.sp.piece_to_id(piece)


def test_each_side_loads_the_others_model(pair, tmp_path):
    mode, j, t = pair
    name = f"{MODES[mode]}_{mode}.model.json"
    (tmp_path / "from_jax").mkdir()
    (tmp_path / "from_torch").mkdir()
    shutil.copy(j.model_path, tmp_path / "from_jax" / name)
    shutil.copy(t.model_path, tmp_path / "from_torch" / name)
    t2 = SentencePiece(str(tmp_path / "from_jax"), MODES[mode],
                       model_type=mode)
    j2 = JaxSentencePiece(str(tmp_path / "from_torch"), MODES[mode],
                          model_type=mode)
    for text in TEXTS:
        assert t2.sp.encode_as_ids(text) == j.sp.encode_as_ids(text)
        assert j2.sp.encode_as_ids(text) == t.sp.encode_as_ids(text)


def test_batch_call_tasks_are_equal(pair):
    _, j, t = pair
    texts = TEXTS[:6]
    assert t(texts) == j(texts)
    assert t(texts, task="encode_from_words") == j(texts)
    arr, lens = t(texts, batch_lens=True)
    jarr, jlens = j(texts, batch_lens=True)
    assert isinstance(arr, torch.Tensor) and arr.dtype == torch.int32
    np.testing.assert_array_equal(arr.numpy(), jarr)
    np.testing.assert_array_equal(lens.numpy(), jlens)
    ids = j(texts)
    assert t(ids, task="decode_from_list") == j(ids, task="decode_from_list")
    assert t(arr, lens, task="decode") == j(jarr, jlens, task="decode")
    with pytest.raises(ValueError):
        t(texts, task="translate")


def test_streaming_detokenizer_is_equal(pair):
    _, j, t = pair
    ids = t.sp.encode_as_ids(" ".join(TEXTS[:3]))
    assert list(StreamingDetokenizer(t.sp).detokenize_stream(ids)) == \
        list(JaxStreamingDetokenizer(j.sp).detokenize_stream(ids))


@pytest.mark.parametrize("options", [
    {"user_defined_symbols": "<sil>,<noise>"},
    {"character_coverage": 0.9},
], ids=["user_symbols", "coverage"])
def test_bpe_options_and_csv_manifest(manifest, tmp_path, options):
    """BPE from a CSV manifest (the port's ``load_data_csv``), with user
    symbols or a character coverage below 1, checked against a
    validation manifest's coverage."""
    _, path = manifest
    with open(path) as f:
        rows = json.load(f)
    csv_path, valid_path = tmp_path / "train.csv", tmp_path / "valid.csv"
    for out, texts in ((csv_path, [r["words"] for r in rows.values()]),
                       (valid_path, TEXTS)):
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["ID", "duration", "wrd"])
            for i, text in enumerate(texts):
                w.writerow([f"u{i}", f"{1.5 + i}", text])
    sides = {}
    for name, cls in (("jax", JaxSentencePiece), ("torch", SentencePiece)):
        sides[name] = cls(str(tmp_path / name), 70,
                          annotation_train=str(csv_path),
                          annotation_read="wrd", model_type="bpe",
                          annotation_list_to_check=[str(valid_path)],
                          **options)
    with open(sides["jax"].model_path, "rb") as a, \
            open(sides["torch"].model_path, "rb") as b:
        assert a.read() == b.read()
    for text in TEXTS:
        assert sides["torch"].sp.encode_as_ids(text) == \
            sides["jax"].sp.encode_as_ids(text)


def test_bpe_refuses_a_vocabulary_smaller_than_its_characters(manifest,
                                                              tmp_path):
    _, path = manifest
    for cls in (JaxSentencePiece, SentencePiece):
        with pytest.raises(ValueError, match="base inventory"):
            cls(str(tmp_path / cls.__module__), 5,
                annotation_train=str(path), annotation_read="words",
                model_type="bpe")
