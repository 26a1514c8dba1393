"""Label <-> index encoders (port of ``speechbrain_tpu/dataio/encoder.py``:
``CategoricalEncoder``, ``TextEncoder``, ``CTCTextEncoder``).

Build a mapping from data or iterables, with unk/bos/eos/blank special
labels, save and load it as a text file, encode and decode sequences on
the host. The file format is the JAX package's, which is the reference's:
``repr(label) => index`` lines, a ``================`` separator, then
``repr(key) => repr(value)`` extras; a file written by either package
loads in the other. Beyond the JAX package, an encoder has a transfer
hook, so a ``Pretrainer`` loads its file (as the reference's falls back
to the load hook); index sequences may be torch tensors.
"""

import ast
import collections
import itertools
import logging
import os

import numpy as np
import torch

from speechbrain_tpu_torch.utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    mark_as_transfer,
    register_checkpoint_hooks,
)

logger = logging.getLogger(__name__)

DEFAULT_UNK = "<unk>"
DEFAULT_BOS = "<bos>"
DEFAULT_EOS = "<eos>"
DEFAULT_BLANK = "<blank>"


def _label_stream(iterable, sequence_input):
    """Flatten an iterable of sequences when requested."""
    return itertools.chain.from_iterable(iterable) if sequence_input else iter(iterable)


@register_checkpoint_hooks
class CategoricalEncoder:
    """Encode a set of hashable labels to integers 0..N-1.

    Example
    -------
    >>> enc = CategoricalEncoder()
    >>> enc.update_from_iterable(["spk0", "spk1", "spk0"])
    >>> enc.encode_label("spk1") in (0, 1)
    True
    >>> enc.decode_ndim(enc.encode_sequence(["spk0", "spk1"]))
    ['spk0', 'spk1']
    """

    VALUE_SEPARATOR = " => "
    EXTRAS_SEPARATOR = "================\n"
    # optional attributes persisted in the extras section of save files;
    # subclasses extend this tuple instead of overriding _get/_set_extras
    _EXTRA_ATTRS = ("unk_label",)

    def __init__(self, starting_index=0, **special_labels):
        self.lab2ind, self.ind2lab = {}, {}
        self.starting_index = starting_index
        self.handle_special_labels(special_labels)

    def handle_special_labels(self, special_labels):
        unk = special_labels.get("unk_label")
        if unk is not None:
            self.add_unk(unk)

    def __len__(self):
        return len(self.lab2ind)

    def is_continuous(self):
        """True if indices form a contiguous range from starting_index."""
        want = range(self.starting_index, self.starting_index + len(self.ind2lab))
        return sorted(self.ind2lab) == list(want)

    def _next_index(self):
        return next(
            i for i in itertools.count(self.starting_index)
            if i not in self.ind2lab
        )

    def _bind(self, label, index):
        self.lab2ind[label], self.ind2lab[index] = index, label

    # -- building ------------------------------------------------------------
    def add_label(self, label):
        if label in self.lab2ind:
            raise KeyError(f"Label already present: {label}")
        fresh = self._next_index()
        self._bind(label, fresh)
        return fresh

    def ensure_label(self, label):
        existing = self.lab2ind.get(label)
        return self.add_label(label) if existing is None else existing

    def insert_label(self, label, index):
        if label in self.lab2ind:
            raise KeyError(f"Label already present: {label}")
        self.enforce_label(label, index)

    def enforce_label(self, label, index):
        """Place label at index, moving any occupant to a fresh index."""
        index = int(index)  # accept numpy and torch scalars
        if self.lab2ind.get(label) == index:
            return
        if label in self.lab2ind:
            # release the label's old slot before re-binding it
            del self.ind2lab[self.lab2ind.pop(label)]
        evicted = self.ind2lab.get(index)
        self._bind(label, index)
        if evicted is not None:
            del self.lab2ind[evicted]
            self._bind(evicted, self._next_index())

    def add_unk(self, unk_label=DEFAULT_UNK):
        self.unk_label = unk_label
        return self.ensure_label(unk_label)

    def update_from_iterable(self, iterable, sequence_input=False):
        """Collect labels from an iterable (or iterable of sequences)."""
        for label in _label_stream(iterable, sequence_input):
            self.ensure_label(label)

    def update_from_didataset(self, didataset, output_key, sequence_input=False):
        """Collect labels from one key of a DynamicItemDataset."""
        with didataset.output_keys_as([output_key]):
            self.update_from_iterable(
                (item[output_key] for item in didataset),
                sequence_input=sequence_input,
            )

    def limited_labelset_from_iterable(
        self, iterable, sequence_input=False, n_most_common=None, min_count=1
    ):
        """Build from label counts with frequency filters; returns Counter."""
        freq = collections.Counter(_label_stream(iterable, sequence_input))
        for lab, n in freq.most_common(n_most_common):
            if n < min_count:
                break
            self.ensure_label(lab)
        return freq

    def expect_len(self, expected_len):
        """Assert the final vocab size (catch config drift early)."""
        if len(self) != expected_len:
            raise RuntimeError(
                f"Encoder has {len(self)} labels, expected {expected_len}"
            )

    def ignore_len(self):
        pass

    # -- encoding ------------------------------------------------------------
    def encode_label(self, label, allow_unk=True):
        index = self.lab2ind.get(label)
        if index is not None:
            return index
        if allow_unk and hasattr(self, "unk_label"):
            return self.lab2ind[self.unk_label]
        raise KeyError(
            f"Unknown label {label}, and no unk_label set "
            "(call add_unk() to allow unknowns)."
        )

    def encode_label_array(self, x, allow_unk=True):
        return np.asarray(
            [self.encode_label(label, allow_unk) for label in x], dtype=np.int32
        )

    def encode_sequence(self, x, allow_unk=True):
        return [self.encode_label(label, allow_unk) for label in x]

    def encode_sequence_array(self, x, allow_unk=True):
        return np.asarray(self.encode_sequence(x, allow_unk), dtype=np.int32)

    # -- decoding ------------------------------------------------------------
    def decode_ind(self, index):
        return self.ind2lab[int(index)]

    def decode_ndim(self, x):
        """Decode an arbitrarily nested structure of indices (lists,
        arrays or tensors)."""
        if isinstance(x, torch.Tensor):
            x = x.tolist()
        try:
            return [self.decode_ndim(sub) for sub in x]
        except TypeError:
            return self.decode_ind(x)

    # -- persistence ---------------------------------------------------------
    def save(self, path):
        parent = os.path.dirname(str(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        sep = self.VALUE_SEPARATOR
        lines = [f"{label!r}{sep}{ind}" for label, ind in self.lab2ind.items()]
        extra_lines = [
            f"{key!r}{sep}{value!r}" for key, value in self._get_extras().items()
        ]
        body = "\n".join(lines) + ("\n" if lines else "")
        body += self.EXTRAS_SEPARATOR
        body += "\n".join(extra_lines) + ("\n" if extra_lines else "")
        with open(path, "w", encoding="utf-8") as fo:
            fo.write(body)

    def load(self, path):
        with open(path, encoding="utf-8") as fi:
            text = fi.read()
        mapping_part, _, extras_part = text.partition(self.EXTRAS_SEPARATOR)
        lab2ind, ind2lab, extras = {}, {}, {}
        for line in mapping_part.splitlines():
            literal, _, ind = line.rpartition(self.VALUE_SEPARATOR)
            lab = ast.literal_eval(literal)
            lab2ind[lab], ind2lab[int(ind)] = int(ind), lab
        for line in extras_part.splitlines():
            key, _, value = line.partition(self.VALUE_SEPARATOR)
            extras[ast.literal_eval(key)] = ast.literal_eval(value)
        self.lab2ind, self.ind2lab = lab2ind, ind2lab
        self._set_extras(extras)

    def load_if_possible(self, path, end_of_epoch=False):
        try:
            self.load(path)
            return True
        except (FileNotFoundError, ValueError, SyntaxError):
            return False

    def load_or_create(
        self,
        path,
        from_iterables=(),
        from_didatasets=(),
        sequence_input=False,
        output_key=None,
        special_labels={},
    ):
        """Load from file if it exists; otherwise build and save."""
        if not self.load_if_possible(path):
            for src in from_iterables:
                self.update_from_iterable(src, sequence_input)
            for ds in from_didatasets:
                self.update_from_didataset(ds, output_key, sequence_input)
            self.handle_special_labels(special_labels)
            self.save(path)
        return True

    def _get_extras(self):
        mapping = {"starting_index": self.starting_index}
        mapping.update(
            (a, getattr(self, a)) for a in self._EXTRA_ATTRS if hasattr(self, a)
        )
        return mapping

    def _set_extras(self, extras):
        self.starting_index = extras["starting_index"]
        for a in self._EXTRA_ATTRS:
            if a in extras:
                setattr(self, a, extras[a])

    @mark_as_saver
    def _save_hook(self, path):
        self.save(path)

    @mark_as_loader
    def _load_hook(self, path, end_of_epoch=False):
        self.load(path)

    @mark_as_transfer
    def _transfer_hook(self, path):
        self.load(path)


class TextEncoder(CategoricalEncoder):
    """CategoricalEncoder with bos/eos sequence support."""

    _EXTRA_ATTRS = CategoricalEncoder._EXTRA_ATTRS + ("bos_label", "eos_label")

    def handle_special_labels(self, special_labels):
        super().handle_special_labels(special_labels)
        bos = special_labels.get("bos_label")
        eos = special_labels.get("eos_label")
        if (bos is None) != (eos is None):
            raise TypeError("Provide both bos_label and eos_label, or neither.")
        if bos is None:
            return
        if bos == eos:
            self.insert_bos_eos(bos_label=bos, eos_label=eos)
        else:
            self.add_bos_eos(bos_label=bos, eos_label=eos)

    def add_bos_eos(self, bos_label=DEFAULT_BOS, eos_label=DEFAULT_EOS):
        for label in {bos_label, eos_label}:
            self.ensure_label(label)
        self.bos_label, self.eos_label = bos_label, eos_label

    def insert_bos_eos(
        self, bos_label=DEFAULT_BOS, eos_label=DEFAULT_EOS, bos_index=0, eos_index=None
    ):
        self.enforce_label(bos_label, bos_index)
        if eos_label != bos_label:
            where = bos_index + 1 if eos_index is None else eos_index
            self.enforce_label(eos_label, where)
        self.bos_label, self.eos_label = bos_label, eos_label

    def get_bos_index(self):
        return self.encode_label(self.bos_label, allow_unk=False)

    def get_eos_index(self):
        return self.encode_label(self.eos_label, allow_unk=False)

    def prepend_bos_label(self, x):
        return [self.bos_label, *x]

    def prepend_bos_index(self, x):
        return [self.get_bos_index(), *x]

    def append_eos_label(self, x):
        return [*x, self.eos_label]

    def append_eos_index(self, x):
        return [*x, self.get_eos_index()]


class CTCTextEncoder(TextEncoder):
    """TextEncoder with a CTC blank and collapse helpers."""

    _EXTRA_ATTRS = TextEncoder._EXTRA_ATTRS + ("blank_label",)

    def handle_special_labels(self, special_labels):
        super().handle_special_labels(special_labels)
        blank = special_labels.get("blank_label")
        if blank is not None:
            self.insert_blank(blank, special_labels.get("blank_index", 0))

    def add_blank(self, blank_label=DEFAULT_BLANK):
        self.ensure_label(blank_label)
        self.blank_label = blank_label

    def insert_blank(self, blank_label=DEFAULT_BLANK, index=0):
        self.enforce_label(blank_label, index)
        self.blank_label = blank_label

    def get_blank_index(self):
        return self.encode_label(self.blank_label, allow_unk=False)

    @staticmethod
    def _dedup(seq):
        return [v for i, v in enumerate(seq) if i == 0 or v != seq[i - 1]]

    def collapse_labels(self, x, merge_repeats=True):
        """CTC-style: drop blanks (and optionally merge repeats)."""
        merged = self._dedup(list(x)) if merge_repeats else list(x)
        return [lab for lab in merged if lab != self.blank_label]

    def collapse_indices_ndim(self, x, merge_repeats=True):
        """Collapse (nested) index sequences CTC-style."""
        if isinstance(x, torch.Tensor):
            x = x.tolist()
        try:
            iter(x[0] if len(x) else 0)
            is_nested = len(x) and not isinstance(x[0], (int, np.integer))
        except TypeError:
            is_nested = False
        if is_nested:
            return [self.collapse_indices_ndim(sub, merge_repeats) for sub in x]
        merged = self._dedup(list(x)) if merge_repeats else list(x)
        blank = self.get_blank_index()
        return [int(ind) for ind in merged if ind != blank]
