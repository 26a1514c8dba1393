"""The port's data pipeline against the JAX package's on the same
manifest and WAV files: ``read_audio``, ``load_data_json``,
``DynamicItemDataset`` (dynamic items, generator items, output keys,
``filtered_sorted``), ``PaddedBatch`` padding with ``pad_to_multiple``,
and the loader's position inside an epoch saved and restored through
each side's ``Checkpointer``, and the shuffled order against JAX's
``ReproducibleRandomSampler``. Everything here is exact: audio samples,
padded arrays, relative lengths and orders must be equal."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import json

import numpy as np
import pytest
import torch

from speechbrain_tpu.dataio.dataio import read_audio as jax_read_audio
from speechbrain_tpu.dataio.dataloader import make_dataloader as jax_loader
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JaxDataset
from speechbrain_tpu.dataio.sampler import (
    ReproducibleRandomSampler as JaxSampler,
)
from speechbrain_tpu.utils.checkpoints import Checkpointer as JaxCheckpointer
from speechbrain_tpu_torch.dataio.batch import PaddedBatch
from speechbrain_tpu_torch.dataio.dataio import (
    load_data_json,
    read_audio,
    write_audio,
)
from speechbrain_tpu_torch.dataio.dataloader import make_dataloader
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.dataio.sampler import ReproducibleRandomSampler
from speechbrain_tpu_torch.utils.checkpoints import Checkpointer

SR = 16000
SECONDS = [0.31, 0.5, 0.12, 0.44, 0.27]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    manifest = {}
    for i, secs in enumerate(SECONDS):
        wav = 0.5 * rng.standard_normal(int(SR * secs)).astype(np.float32)
        write_audio(str(root / f"u{i}.wav"), np.clip(wav, -1, 1), SR)
        n = int(rng.integers(2, 6))
        manifest[f"u{i}"] = {
            "wav": f"$root/u{i}.wav", "length": secs,
            "words": " ".join(str(int(t)) for t in rng.integers(3, 30, n)),
        }
    path = root / "data.json"
    path.write_text(json.dumps(manifest))
    return root, path


def _tokens(words):
    ids = [int(t) for t in words.split()]
    yield np.asarray(ids, np.int32)
    yield np.asarray([1] + ids, np.int32)
    yield np.asarray(ids + [2], np.int32)


def _dataset(cls, read, root, path, sort=True):
    ds = cls.from_json(str(path), replacements={"root": str(root)})
    if sort:
        ds = ds.filtered_sorted(sort_key="length",
                                key_max_value={"length": 0.45})
    ds.add_dynamic_item(read, takes="wav", provides="sig")
    ds.add_dynamic_item(_tokens, takes="words",
                        provides=["tokens", "tokens_bos", "tokens_eos"])
    ds.set_output_keys(["id", "sig", "tokens", "tokens_bos", "tokens_eos"])
    return ds


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_read_audio_matches(corpus):
    root, _ = corpus
    for i in range(len(SECONDS)):
        path = str(root / f"u{i}.wav")
        np.testing.assert_array_equal(read_audio(path),
                                      jax_read_audio(path))
        spec = {"file": path, "start": 100, "stop": 1000}
        np.testing.assert_array_equal(read_audio(spec), jax_read_audio(spec))


def test_write_audio_round_trips_within_two_steps(tmp_path):
    """Writing scales by 32767 and truncates (the JAX package's
    ``write_audio``), reading scales by 1/32768 (as soundfile does): at
    most one step lost to each."""
    wav = np.linspace(-1, 1, 101).astype(np.float32)
    write_audio(str(tmp_path / "x.wav"), wav, SR)
    np.testing.assert_allclose(read_audio(str(tmp_path / "x.wav")), wav,
                               atol=2.0 / 32767)


def test_load_data_json_replacements(corpus):
    root, path = corpus
    data = load_data_json(str(path), {"root": "/data"})
    assert data["u3"]["wav"] == "/data/u3.wav"


@pytest.mark.parametrize("sort", [True, False])
def test_dataset_items_match(corpus, sort):
    root, path = corpus
    jd = _dataset(JaxDataset, jax_read_audio, root, path, sort)
    td = _dataset(DynamicItemDataset, read_audio, root, path, sort)
    assert len(td) == len(jd) == (4 if sort else 5)
    for i in range(len(td)):
        j, t = jd[i], td[i]
        assert list(t) == list(j)
        for key in t:
            np.testing.assert_array_equal(_as_np(t[key]), _as_np(j[key]))


def _batches_equal(tb, jb):
    assert tb.id == jb.id
    for key in ("sig", "tokens", "tokens_bos", "tokens_eos"):
        t, j = tb[key], jb[key]
        assert isinstance(t.data, torch.Tensor)
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.lengths.numpy(),
                                      np.asarray(j.lengths))


PAD = {"sig": 1600, "tokens": 4}


def test_loader_batches_match(corpus):
    root, path = corpus
    jd = _dataset(JaxDataset, jax_read_audio, root, path)
    td = _dataset(DynamicItemDataset, read_audio, root, path)
    jbs = list(jax_loader(jd, batch_size=3, pad_to_multiple=PAD))
    tbs = list(make_dataloader(td, batch_size=3, pad_to_multiple=PAD))
    assert len(tbs) == len(jbs) == 2
    for tb, jb in zip(tbs, jbs):
        _batches_equal(tb, jb)
    assert tbs[0].sig.data.shape[1] % 1600 == 0


def test_shuffled_loaders_give_the_same_batches(corpus):
    """``shuffle=True``, as the recipe trains: over three epochs the two
    loaders yield the same batches, ids and padded arrays alike."""
    root, path = corpus
    jd = _dataset(JaxDataset, jax_read_audio, root, path, sort=False)
    td = _dataset(DynamicItemDataset, read_audio, root, path, sort=False)
    jl = jax_loader(jd, batch_size=2, shuffle=True, pad_to_multiple=PAD)
    tl = make_dataloader(td, batch_size=2, shuffle=True, pad_to_multiple=PAD)
    orders = set()
    for epoch in (1, 2, 3):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jbs, tbs = list(jl), list(tl)
        assert len(tbs) == len(jbs) == 3
        for tb, jb in zip(tbs, jbs):
            _batches_equal(tb, jb)
        orders.add(tuple(i for b in tbs for i in b.id))
    assert len(orders) > 1  # the epochs were shuffled


def test_loader_resumes_inside_an_epoch(corpus, tmp_path):
    """One batch into an epoch, each side saves a checkpoint with its
    loader; a fresh loader recovered from it yields the same remaining
    batches on both sides, which are those of an uninterrupted epoch."""
    root, path = corpus
    sides = {
        "jax": (JaxDataset, jax_read_audio, jax_loader, JaxCheckpointer),
        "torch": (DynamicItemDataset, read_audio, make_dataloader,
                  Checkpointer),
    }
    rest = {}
    for name, (ds_cls, read, loader_fn, ckpt_cls) in sides.items():
        ds = _dataset(ds_cls, read, root, path, sort=False)
        loader = loader_fn(ds, batch_size=2, pad_to_multiple=PAD)
        ckpt = ckpt_cls(tmp_path / name, {"loader": loader})
        it = iter(loader)
        next(it)
        ckpt.save_checkpoint(end_of_epoch=False)
        full = list(loader_fn(ds, batch_size=2, pad_to_multiple=PAD))
        fresh = loader_fn(ds, batch_size=2, pad_to_multiple=PAD)
        ckpt_cls(tmp_path / name, {"loader": fresh}).recover_if_possible()
        rest[name] = list(fresh)
        assert [b.id for b in rest[name]] == [b.id for b in full[1:]]
        assert [b.id for b in fresh] == [b.id for b in full]  # next epoch
    assert len(rest["torch"]) == len(rest["jax"]) == 2
    for tb, jb in zip(rest["torch"], rest["jax"]):
        _batches_equal(tb, jb)


def test_shuffled_order_and_its_resume(corpus, tmp_path):
    root, path = corpus
    ds = _dataset(DynamicItemDataset, read_audio, root, path, sort=False)
    for seed, epoch in ((7, 3), (0, 0), (563375142, 1), (3407, 12)):
        sampler = ReproducibleRandomSampler(list(range(23)), seed=seed)
        jax_sampler = JaxSampler(list(range(23)), seed=seed)
        sampler.set_epoch(epoch)
        jax_sampler.set_epoch(epoch)
        assert list(sampler) == list(jax_sampler), (seed, epoch)
    loader = make_dataloader(ds, batch_size=2, shuffle=True, seed=7)
    loader.set_epoch(3)
    order = list(JaxSampler(range(len(ds)), seed=7, epoch=3))
    ids = [i for b in loader for i in b.id]
    assert ids == [ds.data_ids[k] for k in order]
    ckpt = Checkpointer(tmp_path, {"loader": loader})
    it = iter(loader)
    next(it)
    next(it)
    ckpt.save_checkpoint(end_of_epoch=False)
    fresh = make_dataloader(ds, batch_size=2, shuffle=True, seed=7)
    Checkpointer(tmp_path, {"loader": fresh}).recover_if_possible()
    fresh.set_epoch(3)
    assert [i for b in fresh for i in b.id] == ids[4:]
    assert sorted(ReproducibleRandomSampler(ds, seed=7)) == list(range(5))


def test_padded_batch_to_moves_and_defaults_to_cuda():
    batch = PaddedBatch([{"id": "a", "x": np.ones(3, np.float32)},
                         {"id": "b", "x": np.ones(5, np.float32)}])
    assert batch.to("cpu") is batch
    assert batch.x.data.device.type == "cpu"
    assert batch.x.lengths.tolist() == [0.6000000238418579, 1.0]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            batch.to()
