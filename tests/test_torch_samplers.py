"""The port's samplers and loaders against the JAX package's on the same
datasets: ``DynamicBatchSampler`` (quantile and explicit buckets, every
batch ordering, ``max_batch_ex``, ``drop_last``, several seeds and
epochs), ``ReproducibleWeightedRandomSampler``, ``BalancingDataSampler``
and ``ConcatDatasetBatchSampler`` give the same indices, exactly; the
threaded loader yields the unthreaded loader's batches in order, resumes
inside an epoch on the same batch, and leaves no thread behind;
``LoopedLoader`` counts and checkpoints as JAX's does."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import threading

import numpy as np
import pytest
import torch

from speechbrain_tpu.dataio.dataloader import LoopedLoader as JaxLooped
from speechbrain_tpu.dataio.dataloader import (
    make_dataloader as jax_make_dataloader,
)
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JaxDataset
from speechbrain_tpu.dataio import sampler as jax_sampler
from speechbrain_tpu_torch.dataio import sampler
from speechbrain_tpu_torch.dataio.dataloader import (
    LoopedLoader,
    SaveableDataLoader,
    make_dataloader,
)
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return {f"u{i:02d}": {"duration": float(rng.uniform(1.0, 9.0)),
                          "spk": f"s{int(rng.integers(0, 4))}",
                          "x": rng.standard_normal(int(rng.integers(2, 7)))
                          .astype(np.float32)}
            for i in range(n)}


def _datasets(n=40, seed=0):
    data = _data(n, seed)
    pair = JaxDataset(data), DynamicItemDataset(data)
    for ds in pair:
        ds.set_output_keys(["id", "x"])
    return pair


@pytest.mark.parametrize("ordering", ["random", "ascending", "descending"])
@pytest.mark.parametrize("kw", [
    {"num_buckets": 4},
    {"num_buckets": 3, "max_batch_ex": 3, "drop_last": True},
    {"bucket_boundaries": [2.0, 4.5, 7.0], "shuffle": False},
])
def test_dynamic_batches_match_jax(ordering, kw):
    jds, tds = _datasets()
    args = dict(max_batch_length=20.0, batch_ordering=ordering, **kw)
    for seed in (0, 42):
        j = jax_sampler.DynamicBatchSampler(jds, seed=seed, **args)
        t = sampler.DynamicBatchSampler(tds, seed=seed, **args)
        for epoch in (0, 1, 5):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(t) == list(j)
            assert len(t) == len(j)
            for batch in t:
                assert (sum(t.get_durations(batch)) <= 20.0
                        or len(batch) == 1)


def test_dynamic_batches_take_a_lengths_list():
    jds, tds = _datasets(12)
    lengths = [float(v) for v in np.linspace(0.5, 6.0, 12)]
    j = jax_sampler.DynamicBatchSampler(jds, 8.0, num_buckets=2,
                                        lengths_list=lengths)
    t = sampler.DynamicBatchSampler(tds, 8.0, num_buckets=2,
                                    lengths_list=lengths)
    assert list(t) == list(j)
    with pytest.raises(ValueError):
        sampler.DynamicBatchSampler(tds, 8.0)


def test_weighted_and_balancing_samplers_match_jax():
    weights = np.random.default_rng(1).uniform(0, 1, 30)
    for replacement in (True, False):
        j = jax_sampler.ReproducibleWeightedRandomSampler(
            weights, 20, replacement=replacement)
        t = sampler.ReproducibleWeightedRandomSampler(
            weights, 20, replacement=replacement)
        for epoch in (0, 3):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(t) == list(j)
    data = _data()
    jds, tds = JaxDataset(data), DynamicItemDataset(data)
    j = jax_sampler.BalancingDataSampler(jds, "spk")
    t = sampler.BalancingDataSampler(tds, "spk")
    np.testing.assert_array_equal(t.weights, j.weights)
    assert list(t) == list(j) and len(t) == len(j) == 40


def test_concat_batch_sampler_matches_jax():
    sizes = (7, 11)
    j = jax_sampler.ConcatDatasetBatchSampler(
        [jax_sampler.ReproducibleRandomSampler(list(range(n)), seed=3)
         for n in sizes], [2, 3])
    t = sampler.ConcatDatasetBatchSampler(
        [sampler.ReproducibleRandomSampler(list(range(n)), seed=3)
         for n in sizes], [2, 3])
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        assert list(t) == list(j)
    assert len(t) == len(j) == 3


def _ids(loader):
    return [list(b.id) for b in loader]


@pytest.mark.parametrize("workers", [1, 4])
def test_threaded_loader_yields_the_same_batches(workers):
    _, tds = _datasets()
    dyn = dict(max_batch_length=15.0, num_buckets=3)
    plain = make_dataloader(tds, batch_sampler=sampler.DynamicBatchSampler(
        tds, **dyn))
    threaded = make_dataloader(tds, num_workers=workers,
                               batch_sampler=sampler.DynamicBatchSampler(
                                   tds, **dyn))
    for epoch in (1, 2):
        plain.set_epoch(epoch)
        threaded.set_epoch(epoch)
        assert _ids(threaded) == _ids(plain)
    shuffled = [make_dataloader(tds, batch_size=3, shuffle=True,
                                drop_last=True, num_workers=w)
                for w in (0, workers)]
    assert _ids(shuffled[0]) == _ids(shuffled[1])
    assert len(shuffled[0]) == 13 == len(_ids(shuffled[0]))


def test_threaded_resume_starts_on_the_unthreaded_batch(tmp_path):
    _, tds = _datasets()

    def loader(workers):
        return make_dataloader(
            tds, num_workers=workers,
            batch_sampler=sampler.DynamicBatchSampler(
                tds, 15.0, num_buckets=3, seed=7))

    reference = loader(0)
    reference.set_epoch(2)
    expected = _ids(reference)
    threaded = loader(4)
    threaded.set_epoch(2)
    it = iter(threaded)
    for _ in range(3):
        next(it)
    threaded._save(tmp_path / "loader.ckpt")  # 8 more are read ahead
    del it
    for workers in (0, 4):
        fresh = loader(workers)
        fresh._load(tmp_path / "loader.ckpt", end_of_epoch=False)
        fresh.set_epoch(2)
        assert _ids(fresh) == expected[3:]


def test_a_break_leaves_no_loader_thread():
    _, tds = _datasets()
    loader = make_dataloader(tds, batch_size=2, num_workers=4)
    for epoch in range(3):
        for i, _ in enumerate(loader):
            if i == 2:
                break
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("loader")]


def test_looped_loader_matches_jax(tmp_path):
    jds, tds = _datasets(7)
    j = JaxLooped(jax_make_dataloader(jds, batch_size=2), 5)
    t = make_dataloader(tds, batch_size=2, looped_nominal_epoch=5)
    assert isinstance(t, LoopedLoader)
    assert isinstance(t.loader, SaveableDataLoader)
    for _ in range(2):
        assert [list(b.id) for b in t] == [list(b.id) for b in j]
    assert (t.step, t.total_steps, t.total_samples) == (
        j.step, j.total_steps, j.total_samples) == (0, 10, 18)
    it = iter(t)
    next(it)
    t._save(tmp_path / "looped.ckpt")
    fresh = make_dataloader(tds, batch_size=2, looped_nominal_epoch=5)
    fresh._load(tmp_path / "looped.ckpt", end_of_epoch=False)
    assert (fresh.step, fresh.total_steps, fresh.total_samples) == (
        1, 11, 20)
    assert len(list(fresh)) == 4


def test_threaded_loader_under_stress_yields_the_plain_batches():
    """Twice as many threads as the host has cores, the interpreter
    switching threads as often as it can: every batch, ids and padded
    data, equals the unthreaded loader's."""
    import os
    import sys

    _, tds = _datasets(60)
    tds.set_output_keys(["id", "x"])
    plain = [(list(b.id), b.x.data.clone()) for b in
             make_dataloader(tds, batch_size=3, shuffle=True)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threaded = [(list(b.id), b.x.data) for b in make_dataloader(
            tds, batch_size=3, shuffle=True,
            num_workers=2 * (os.cpu_count() or 4))]
    finally:
        sys.setswitchinterval(interval)
    assert len(threaded) == len(plain) == 20
    for (ids, x), (pids, px) in zip(threaded, plain):
        assert ids == pids
        assert torch.equal(x, px)
