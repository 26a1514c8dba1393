"""The port's label encoders (``speechbrain_tpu_torch/dataio/encoder.py``)
against ``speechbrain_tpu.dataio.encoder`` on the same labels: the label
file byte for byte (and each package loading the other's), special labels
(unk, bos/eos, the CTC blank at index 0 or elsewhere), ``encode_sequence``,
``encode_sequence_array``, ``decode_ndim`` on nested lists, arrays and
tensors, ``collapse_indices_ndim``, ``load_or_create`` from a dataset, and
the transfer hook through which a ``Pretrainer`` loads a label file. Every
comparison is exact: these are integers and strings."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import json

import numpy as np
import pytest
import torch

from speechbrain_tpu.dataio import encoder as jenc
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JaxDataset
from speechbrain_tpu.utils.checkpoints import (
    DEFAULT_TRANSFER_HOOKS as JAX_TRANSFER_HOOKS,
)
from speechbrain_tpu_torch.dataio import encoder as tenc
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.utils.checkpoints import (
    DEFAULT_TRANSFER_HOOKS,
    get_default_hook,
)
from speechbrain_tpu_torch.utils.parameter_transfer import Pretrainer

WORDS = ["hi there", "go now", "stop it", "hello", "ok"]
DATA = {f"u{i}": {"words": w} for i, w in enumerate(WORDS)}


def _build(module, cls, special):
    enc = getattr(module, cls)()
    enc.update_from_iterable(WORDS, sequence_input=True)
    if special:
        enc.handle_special_labels(special)
    return enc


SPECIALS = [
    ("CategoricalEncoder", {}),
    ("CategoricalEncoder", {"unk_label": "<unk>"}),
    ("TextEncoder", {"bos_label": "<bos>", "eos_label": "<eos>"}),
    ("TextEncoder", {"bos_label": "<s>", "eos_label": "<s>"}),
    ("CTCTextEncoder", {"blank_label": 0}),
    ("CTCTextEncoder", {"blank_label": "<blank>", "blank_index": 3,
                        "bos_label": "<bos>", "eos_label": "<eos>"}),
]


@pytest.mark.parametrize("cls,special", SPECIALS,
                         ids=[f"{c}-{i}" for i, (c, _) in
                              enumerate(SPECIALS)])
def test_label_file_and_mapping_equal(tmp_path, cls, special):
    j, t = _build(jenc, cls, special), _build(tenc, cls, special)
    assert t.lab2ind == j.lab2ind and t.ind2lab == j.ind2lab
    j.save(tmp_path / "jax.txt")
    t.save(tmp_path / "torch.txt")
    assert (tmp_path / "torch.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    # each package loads the other's file
    t2, j2 = getattr(tenc, cls)(), getattr(jenc, cls)()
    t2.load(tmp_path / "jax.txt")
    j2.load(tmp_path / "torch.txt")
    assert t2.lab2ind == j.lab2ind and j2.lab2ind == t.lab2ind
    for attr in ("unk_label", "bos_label", "eos_label", "blank_label",
                 "starting_index"):
        assert getattr(t2, attr, None) == getattr(j, attr, None), attr


def test_encode_decode_collapse_equal():
    special = {"blank_label": 0, "unk_label": "<unk>"}
    j = _build(jenc, "CTCTextEncoder", special)
    t = _build(tenc, "CTCTextEncoder", special)
    for text in ("hi there", "zoo?", ""):
        chars = list(text)
        assert t.encode_sequence(chars) == j.encode_sequence(chars)
        a, b = t.encode_sequence_array(chars), j.encode_sequence_array(chars)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    ids = [[1, 1, 0, 2, 2, 2, 0, 0, 3], [4, 0, 4, 5]]
    assert t.decode_ndim(ids) == j.decode_ndim(ids)
    assert t.decode_ndim(np.array(ids[1])) == j.decode_ndim(np.array(ids[1]))
    assert t.decode_ndim(torch.tensor(ids[1])) == j.decode_ndim(ids[1])
    for merge in (True, False):
        assert t.collapse_indices_ndim(ids, merge) == \
            j.collapse_indices_ndim(ids, merge)
        assert t.collapse_indices_ndim(torch.tensor(ids[0]), merge) == \
            j.collapse_indices_ndim(ids[0], merge)
    assert t.collapse_labels(list("aa-b-"), True) == \
        j.collapse_labels(list("aa-b-"), True)
    assert t.get_blank_index() == j.get_blank_index() == 0
    with pytest.raises(KeyError):
        tenc.CategoricalEncoder().encode_label("x")


def test_load_or_create_from_dataset(tmp_path):
    manifest = tmp_path / "train.json"
    manifest.write_text(json.dumps(DATA))
    files = {}
    for name, module, ds_cls in (("jax", jenc, JaxDataset),
                                 ("torch", tenc, DynamicItemDataset)):
        ds = ds_cls.from_json(str(manifest))
        ds.add_dynamic_item(lambda w: list(w), takes="words",
                            provides="chars")
        enc = module.CTCTextEncoder()
        path = tmp_path / f"{name}.txt"
        enc.load_or_create(path, from_didatasets=[ds], output_key="chars",
                           sequence_input=True,
                           special_labels={"blank_label": 0})
        files[name] = path.read_bytes()
        again = module.CTCTextEncoder()
        again.load_or_create(path)  # loads: nothing to build from
        assert again.lab2ind == enc.lab2ind
    assert files["torch"] == files["jax"]


def test_pretrainer_loads_a_label_file(tmp_path):
    """The JAX encoder has no transfer hook, so JAX's Pretrainer cannot
    load one; the port's loads it, as the reference falls back to the
    load hook."""
    src = _build(tenc, "CTCTextEncoder", {"blank_label": 0})
    src.save(tmp_path / "label_encoder.ckpt")
    target = tenc.CTCTextEncoder()
    assert get_default_hook(target, DEFAULT_TRANSFER_HOOKS) is not None
    assert get_default_hook(jenc.CTCTextEncoder(),
                            JAX_TRANSFER_HOOKS) is None
    pt = Pretrainer(collect_in=tmp_path / "collected",
                    loadables={"label_encoder": target})
    pt.collect_files(default_source=str(tmp_path))
    pt.load_collected()
    assert target.lab2ind == src.lab2ind
    assert target.blank_label == 0
