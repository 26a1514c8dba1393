"""The port's ``InputNormalization`` against the JAX package's on the same
numpy features and relative lengths: the sentence, batch, speaker and
global types, the running statistics of the global and speaker types over
several batches (and the global one's freeze after
``update_until_epoch``), and their checkpoints; and ``GlobalNorm``
(running mean and std, freeze, ``denormalize``).

Tolerance: 1e-5 absolute on outputs of size about 1 (float32 masked sums
over up to 12 frames in another order)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechbrain_tpu.processing.features import GlobalNorm as JaxGlobalNorm
from speechbrain_tpu.processing.features import (
    InputNormalization as JaxNorm,
)
from speechbrain_tpu_torch.processing.features import (
    GlobalNorm,
    InputNormalization,
)

ATOL = 1e-5
LENS = np.array([1.0, 0.5, 0.75], np.float32)


def _feats(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 12, 5)) * 4.0 + 2.0).astype(np.float32)


@pytest.mark.parametrize("norm_type", ["sentence", "batch"])
@pytest.mark.parametrize("mean_norm,std_norm",
                         [(True, True), (True, False), (False, True)])
def test_stateless_types_match(norm_type, mean_norm, std_norm):
    x = _feats(0)
    kw = dict(norm_type=norm_type, mean_norm=mean_norm, std_norm=std_norm)
    j = JaxNorm(**kw)(jnp.asarray(x), jnp.asarray(LENS))
    t = InputNormalization(**kw)(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("avg_factor", [None, 0.3])
def test_global_running_statistics_match(avg_factor, tmp_path):
    j = JaxNorm(norm_type="global", avg_factor=avg_factor,
                update_until_epoch=2)
    t = InputNormalization(norm_type="global", avg_factor=avg_factor,
                           update_until_epoch=2)
    for seed, epoch in ((1, 0), (2, 1), (3, 1), (4, 2)):
        x = _feats(seed)
        jo = j(jnp.asarray(x), jnp.asarray(LENS), epoch=epoch)
        to = t(torch.from_numpy(x), torch.from_numpy(LENS), epoch=epoch)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    assert t.count == j.count == 3  # frozen from epoch 2 on
    np.testing.assert_allclose(t.glob_mean.numpy(), np.asarray(j.glob_mean),
                               atol=ATOL)
    t._save(tmp_path / "norm.ckpt")
    fresh = InputNormalization(norm_type="global")
    fresh._load(tmp_path / "norm.ckpt")
    x = torch.from_numpy(_feats(5))
    assert torch.equal(fresh(x, torch.from_numpy(LENS), epoch=9),
                       t(x, torch.from_numpy(LENS), epoch=9))


def test_statistics_stay_float32_under_autocast():
    x = torch.from_numpy(_feats(6))
    norm = InputNormalization(norm_type="sentence")
    with torch.autocast("cpu", torch.bfloat16):
        out = norm(x.to(torch.bfloat16), torch.from_numpy(LENS))
    assert out.dtype == torch.float32


@pytest.mark.parametrize("avg_factor", [None, 0.3])
def test_speaker_running_statistics_match(avg_factor, tmp_path):
    j = JaxNorm(norm_type="speaker", avg_factor=avg_factor)
    t = InputNormalization(norm_type="speaker", avg_factor=avg_factor)
    for seed, spk in ((1, ["a", "b", "a"]), (2, ["c", "a", "b"]),
                      (3, ["b", "b", "a"])):
        x = _feats(seed)
        jo = j(jnp.asarray(x), jnp.asarray(LENS), spk_ids=spk)
        to = t(torch.from_numpy(x), torch.from_numpy(LENS), spk_ids=spk)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    assert t.spk_dict_count == j.spk_dict_count == {"a": 4, "b": 4, "c": 1}
    for spk in "abc":
        np.testing.assert_allclose(t.spk_dict_mean[spk].numpy(),
                                   np.asarray(j.spk_dict_mean[spk]),
                                   atol=ATOL)
    t._save(tmp_path / "spk.ckpt")
    fresh = InputNormalization(norm_type="speaker", avg_factor=avg_factor)
    fresh._load(tmp_path / "spk.ckpt")
    assert fresh.spk_dict_count == t.spk_dict_count
    x = torch.from_numpy(_feats(4))
    assert torch.equal(fresh(x, torch.from_numpy(LENS), spk_ids=["c"] * 3),
                       t(x, torch.from_numpy(LENS), spk_ids=["c"] * 3))


def test_global_norm_matches():
    j = JaxGlobalNorm(norm_mean=0.5, norm_std=2.0, update_steps=2)
    t = GlobalNorm(norm_mean=0.5, norm_std=2.0, update_steps=2)
    for seed in (1, 2, 3):
        x = _feats(seed)
        np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(),
                                   np.asarray(j(jnp.asarray(x))),
                                   rtol=1e-5, atol=ATOL)
    assert t.step_count == j.step_count == 2  # no update past update_steps
    assert t.running_mean == pytest.approx(j.running_mean, rel=1e-6)
    assert t.running_std == pytest.approx(j.running_std, rel=1e-6)
    y = torch.from_numpy(_feats(5))
    np.testing.assert_allclose(t.denormalize(y).numpy(),
                               np.asarray(j.denormalize(jnp.asarray(
                                   y.numpy()))), rtol=1e-5, atol=ATOL)
    frozen = GlobalNorm()
    frozen.freeze()
    frozen(y)
    assert frozen.step_count == 0
    frozen.unfreeze()
    frozen(y)
    assert frozen.step_count == 1
