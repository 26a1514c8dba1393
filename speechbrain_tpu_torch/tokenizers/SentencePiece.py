"""BPE, unigram and char tokenizers with SentencePiece's surface (port of
``speechbrain_tpu/tokenizers/SentencePiece.py``).

Pure Python and numpy: training from a JSON or CSV manifest, a ``.sp``
processor (``encode_as_ids``, ``encode_as_pieces``, ``decode_ids``,
``id_to_piece``, ``piece_to_id``, ``vocab_size``), the batch call of the
reference and streaming detokenization. Models are ``.model.json`` files
written byte for byte as the JAX package writes them, so that a tokenizer
trained by either package loads in the other.

Unigram training inherits the JAX package's order: its seed pieces come
from a ``set`` of strings, whose order follows Python's string hashing,
so the trained pieces can change with ``PYTHONHASHSEED``. Within one
process the two packages give the same model.
"""

import collections
import json
import logging
import os

import numpy as np
import torch

from speechbrain_tpu_torch.dataio.dataio import load_data_csv, load_data_json
from speechbrain_tpu_torch.utils.data_utils import batch_pad_right, undo_padding

logger = logging.getLogger(__name__)

WORD_BOUNDARY = "▁"  # same meta symbol sentencepiece uses


class _BPEProcessor:
    """Minimal sentencepiece-processor-compatible BPE engine."""

    def __init__(self, pieces, merges, unk_piece="<unk>"):
        # pieces: list of piece strings, id = index
        self.pieces = list(pieces)
        self.piece2id = {p: i for i, p in enumerate(self.pieces)}
        self.merges = {tuple(m): i for i, m in enumerate(merges)}
        self.unk_piece = unk_piece
        if unk_piece not in self.piece2id:
            self.pieces.insert(0, unk_piece)
            self.piece2id = {p: i for i, p in enumerate(self.pieces)}

    # -- sentencepiece API surface -----------------------------------------
    def vocab_size(self):
        return len(self.pieces)

    def get_piece_size(self):
        return len(self.pieces)

    def id_to_piece(self, idx):
        if isinstance(idx, (list, tuple, np.ndarray)):
            return [self.pieces[int(i)] for i in idx]
        return self.pieces[int(idx)]

    def piece_to_id(self, piece):
        return self.piece2id.get(piece, self.piece2id[self.unk_piece])

    def _encode_word(self, word):
        symbols = list(word)
        if not symbols:
            return []
        while len(symbols) > 1:
            best_rank, best_i = None, None
            for i in range(len(symbols) - 1):
                rank = self.merges.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_i is None:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols

    def encode_as_pieces(self, text):
        pieces = []
        for word in str(text).split():
            pieces.extend(self._encode_word(WORD_BOUNDARY + word))
        return pieces

    def encode_as_ids(self, text):
        return [self.piece_to_id(p) for p in self.encode_as_pieces(text)]

    def decode_pieces(self, pieces):
        text = "".join(pieces)
        return text.replace(WORD_BOUNDARY, " ").strip()

    def decode_ids(self, ids):
        return self.decode_pieces(self.id_to_piece(list(ids)))

    decode = decode_ids

    # -- persistence ----------------------------------------------------------
    def save(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "pieces": self.pieces,
                    "merges": [list(m) for m, _ in sorted(
                        self.merges.items(), key=lambda kv: kv[1]
                    )],
                    "unk": self.unk_piece,
                },
                f,
                ensure_ascii=False,
            )

    @classmethod
    def load(cls, path):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(data["pieces"], [tuple(m) for m in data["merges"]], data["unk"])


def _train_bpe(texts, vocab_size, character_coverage=1.0, user_symbols=()):
    """Classic BPE training: start from characters, merge the most frequent
    adjacent pair until vocab_size is reached."""
    word_freq = collections.Counter()
    for line in texts:
        for word in str(line).split():
            word_freq[WORD_BOUNDARY + word] += 1
    # initial symbol vocabulary: characters
    char_freq = collections.Counter()
    for word, freq in word_freq.items():
        for ch in word:
            char_freq[ch] += freq
    if character_coverage < 1.0:
        total = sum(char_freq.values())
        kept, acc = set(), 0
        for ch, f in char_freq.most_common():
            kept.add(ch)
            acc += f
            if acc / total >= character_coverage:
                break
    else:
        kept = set(char_freq)
    words = {
        tuple(ch if ch in kept else "<unk>" for ch in word): freq
        for word, freq in word_freq.items()
    }
    pieces = ["<unk>"] + list(user_symbols) + sorted(kept)
    if len(pieces) > vocab_size:
        # real sentencepiece refuses too; silently overflowing emits ids
        # >= vocab_size and poisons every downstream loss with NaN
        raise ValueError(
            f"vocab_size={vocab_size} is smaller than the base inventory "
            f"({len(pieces)}: unk + user symbols + {len(kept)} chars); "
            "raise vocab_size or lower character_coverage"
        )
    merges = []
    while len(pieces) < vocab_size:
        pair_freq = collections.Counter()
        for word, freq in words.items():
            for i in range(len(word) - 1):
                pair_freq[(word[i], word[i + 1])] += freq
        if not pair_freq:
            break
        (a, b), freq = pair_freq.most_common(1)[0]
        if freq < 2:
            break
        merges.append((a, b))
        new_piece = a + b
        pieces.append(new_piece)
        new_words = {}
        for word, f in words.items():
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(new_piece)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + f
        words = new_words
    return pieces, merges


class _UnigramProcessor:
    """Unigram-LM tokenizer: encode = Viterbi segmentation maximizing the
    sum of piece log-probabilities (the SentencePiece unigram model)."""

    def __init__(self, pieces, logprobs, unk_piece="<unk>"):
        self.pieces = list(pieces)
        self.logprobs = {p: float(lp) for p, lp in zip(pieces, logprobs)}
        self.unk = unk_piece
        self._p2i = {p: i for i, p in enumerate(self.pieces)}
        self.max_len = max((len(p) for p in self.pieces), default=1)

    def vocab_size(self):
        return len(self.pieces)

    def get_piece_size(self):
        return len(self.pieces)

    def id_to_piece(self, idx):
        return self.pieces[idx]

    def piece_to_id(self, piece):
        return self._p2i.get(piece, self._p2i.get(self.unk, 0))

    def _viterbi(self, text):
        n = len(text)
        best = [float("-inf")] * (n + 1)
        back = [None] * (n + 1)
        best[0] = 0.0
        unk_lp = min(self.logprobs.values(), default=-10.0) - 10.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                piece = text[i:j]
                lp = self.logprobs.get(piece)
                if lp is None:
                    if j - i == 1:  # unknown character
                        lp = unk_lp
                    else:
                        continue
                if best[i] + lp > best[j]:
                    best[j] = best[i] + lp
                    back[j] = i
        out = []
        j = n
        while j > 0:
            i = back[j]
            out.append(text[i:j])
            j = i
        return out[::-1]

    def encode_as_pieces(self, text):
        pieces = []
        for word in str(text).split():
            pieces.extend(self._viterbi(WORD_BOUNDARY + word))
        return pieces

    def encode_as_ids(self, text):
        return [self.piece_to_id(p) for p in self.encode_as_pieces(text)]

    def decode_pieces(self, pieces):
        return "".join(pieces).replace(WORD_BOUNDARY, " ").strip()

    def decode_ids(self, ids):
        return self.decode_pieces([self.pieces[int(i)] for i in ids])

    def save(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "type": "unigram",
                    "pieces": self.pieces,
                    "logprobs": [self.logprobs[p] for p in self.pieces],
                    "unk": self.unk,
                },
                f,
            )

    @classmethod
    def load(cls, path):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(data["pieces"], data["logprobs"], data["unk"])


def _train_unigram(texts, vocab_size, user_symbols=(), max_piece_len=10,
                   n_em_iters=4, prune_frac=0.2):
    """Unigram-LM training (the SentencePiece unigram algorithm,
    Viterbi-EM approximation): seed with frequent substrings, alternate
    (1) Viterbi-segment the corpus with current piece probabilities and
    re-estimate from counts, (2) prune the lowest-probability
    multi-char pieces, until the vocab fits."""
    import math

    word_freq = collections.Counter()
    for line in texts:
        for word in str(line).split():
            word_freq[WORD_BOUNDARY + word] += 1

    # seed: all substrings up to max_piece_len, scored by freq * len
    sub_freq = collections.Counter()
    for word, freq in word_freq.items():
        for i in range(len(word)):
            for j in range(i + 1, min(len(word), i + max_piece_len) + 1):
                sub_freq[word[i:j]] += freq
    chars = {w[i] for w in word_freq for i in range(len(w))}
    seed_size = max(vocab_size * 4, len(chars) + 1)
    seeds = {s for s, _ in sub_freq.most_common(seed_size)} | chars
    total = sum(sub_freq[s] for s in seeds)
    logprobs = {
        s: math.log(max(sub_freq[s], 1) / total) for s in seeds
    }

    def em_round(lps):
        proc = _UnigramProcessor(list(lps), [lps[p] for p in lps])
        counts = collections.Counter()
        for word, freq in word_freq.items():
            for piece in proc._viterbi(word):
                counts[piece] += freq
        tot = sum(counts.values())
        return counts, tot

    target_multi = vocab_size - len(chars) - 1 - len(user_symbols)
    while True:
        for _ in range(n_em_iters):
            counts, tot = em_round(logprobs)
            logprobs = {
                p: math.log(max(counts.get(p, 0), 1e-3) / max(tot, 1))
                for p in logprobs
            }
        multi = [p for p in logprobs if len(p) > 1 and p not in chars]
        if len(multi) <= max(target_multi, 0):
            break
        # prune the worst multi-char pieces (chars are never pruned)
        multi.sort(key=lambda p: logprobs[p])
        n_drop = max(1, int(len(multi) * prune_frac))
        n_drop = min(n_drop, len(multi) - max(target_multi, 0))
        for p in multi[:n_drop]:
            del logprobs[p]

    pieces = ["<unk>"] + list(user_symbols) + sorted(
        logprobs, key=lambda p: -logprobs[p]
    )[: vocab_size - 1 - len(user_symbols)]
    min_lp = min(logprobs.values(), default=-10.0)
    return pieces, [logprobs.get(p, min_lp - 5.0) for p in pieces]


class SentencePiece:
    """Train/load a tokenizer from a data manifest
    (reference tokenizers/SentencePiece.py:24).

    Arguments mirror the reference: model_dir, vocab_size, annotation_train
    (csv/json manifest), annotation_read (text column), model_type
    ("bpe"|"char"|"unigram"), character_coverage,
    bos_id/eos_id/pad_id/unk_id.

    Example
    -------
    >>> import tempfile, json, os
    >>> d = tempfile.mkdtemp()
    >>> ann = os.path.join(d, "train.json")
    >>> with open(ann, "w") as f:
    ...     json.dump({"u1": {"words": "hello world"},
    ...                "u2": {"words": "hello there"}}, f)
    >>> sp = SentencePiece(d, vocab_size=40, annotation_train=ann,
    ...                    annotation_read="words", model_type="bpe")
    >>> ids = sp.sp.encode_as_ids("hello world")
    >>> sp.sp.decode_ids(ids)
    'hello world'
    """

    def __init__(
        self,
        model_dir,
        vocab_size,
        annotation_train=None,
        annotation_read=None,
        model_type="unigram",
        char_format_input=False,
        character_coverage=1.0,
        user_defined_symbols=None,
        max_sentencepiece_length=10,
        bos_id=-1,
        eos_id=-1,
        pad_id=-1,
        unk_id=0,
        split_by_whitespace=True,
        num_sequences=None,
        annotation_list_to_check=None,
        annotation_format="csv",
        text_file=None,
        add_dummy_prefix=True,
    ):
        self.model_dir = model_dir
        self.vocab_size = int(vocab_size)
        self.model_type = model_type
        os.makedirs(model_dir, exist_ok=True)
        prefix = os.path.join(model_dir, f"{self.vocab_size}_{model_type}")
        self.model_path = prefix + ".model.json"
        user_symbols = []
        if user_defined_symbols:
            user_symbols = (
                user_defined_symbols.split(",")
                if isinstance(user_defined_symbols, str)
                else list(user_defined_symbols)
            )
        if os.path.exists(self.model_path):
            with open(self.model_path, encoding="utf-8") as f:
                saved_type = json.load(f).get("type", "bpe")
            cls = (
                _UnigramProcessor if saved_type == "unigram"
                else _BPEProcessor
            )
            self.sp = cls.load(self.model_path)
            logger.info("Loaded tokenizer from %s", self.model_path)
        else:
            if annotation_train is None and text_file is None:
                raise ValueError(
                    f"No tokenizer at {self.model_path} and no training data given"
                )
            texts = self._read_texts(
                annotation_train, annotation_read, annotation_format, text_file
            )
            if model_type == "char":
                chars = sorted({ch for t in texts for ch in t.replace(" ", WORD_BOUNDARY)})
                pieces = ["<unk>"] + user_symbols + chars
                self.sp = _BPEProcessor(pieces, merges=[])
                # char mode: encode via single-char merges only
            elif model_type == "unigram":
                pieces, logprobs = _train_unigram(
                    texts, self.vocab_size, user_symbols,
                    max_piece_len=max_sentencepiece_length,
                )
                self.sp = _UnigramProcessor(pieces, logprobs)
            else:
                pieces, merges = _train_bpe(
                    texts, self.vocab_size, character_coverage, user_symbols
                )
                self.sp = _BPEProcessor(pieces, merges)
            self.sp.save(self.model_path)
            logger.info(
                "Trained %s tokenizer (%d pieces) -> %s",
                model_type, self.sp.vocab_size(), self.model_path,
            )
        if annotation_list_to_check is not None:
            self._check_coverage(
                annotation_list_to_check, annotation_read, annotation_format
            )

    @staticmethod
    def _read_texts(annotation_train, annotation_read, annotation_format, text_file):
        if text_file is not None:
            with open(text_file, encoding="utf-8") as f:
                return [line.strip() for line in f if line.strip()]
        if annotation_train.endswith(".json") or annotation_format == "json":
            data = load_data_json(annotation_train)
        else:
            data = load_data_csv(annotation_train)
        return [str(row[annotation_read]) for row in data.values()]

    def _check_coverage(self, annotations, annotation_read, annotation_format):
        for ann in annotations:
            texts = self._read_texts(ann, annotation_read, annotation_format, None)
            n_unk = 0
            n_tok = 0
            unk_id = self.sp.piece_to_id("<unk>")
            for t in texts:
                ids = self.sp.encode_as_ids(t)
                n_tok += len(ids)
                n_unk += sum(1 for i in ids if i == unk_id)
            cov = 100.0 * (1 - n_unk / max(1, n_tok))
            logger.info("Vocab coverage on %s: %.2f%%", ann, cov)

    def __call__(self, batch, batch_lens=None, ind2lab=None, task="encode"):
        """Batch encode or decode, the reference's call contract.

        ``task="encode"`` (or ``"encode_from_words"``): a list of strings
        to a list of id lists, or, given ``batch_lens``, to a padded
        int32 tensor and float32 relative lengths. ``"decode_from_list"``:
        id lists to word lists. ``"decode"``: a padded id tensor and its
        relative lengths to word lists."""
        if task == "encode_from_words" or task == "encode":
            ids = [self.sp.encode_as_ids(t) for t in batch]
            if batch_lens is None:
                return ids
            arr, lens = batch_pad_right([np.asarray(x, np.int32) for x in ids])
            return torch.from_numpy(arr), torch.from_numpy(lens)
        if task == "decode_from_list":
            return [self.sp.decode_ids([int(i) for i in seq]).split() for seq in batch]
        if task == "decode":
            utts = undo_padding(batch, batch_lens)
            return [self.sp.decode_ids([int(i) for i in seq]).split() for seq in utts]
        raise ValueError(f"Unknown task {task}")

    def decode_ids(self, ids):
        return self.sp.decode_ids([int(i) for i in ids])


class StreamingDetokenizer:
    """Incremental detokenization preserving leading spaces
    (reference SentencePiece.py:519)."""

    def __init__(self, sp):
        self.sp = sp

    def detokenize_stream(self, piece_ids):
        """Yield text increments for a stream of piece ids."""
        for pid in piece_ids:
            piece = self.sp.id_to_piece(int(pid))
            yield piece.replace(WORD_BOUNDARY, " ")
