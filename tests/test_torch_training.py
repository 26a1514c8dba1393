"""The training slice as a whole against the JAX package, at a small size:
the LibriSpeech conformer CTC/attention recipe's ``ASR`` Brain
(``recipes/LibriSpeech/ASR/transformer/train.py``, imported as it is)
against its twin on the port (``chip_smoke.ASR``, imported there from the
twin recipe ``speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transformer/
train.py``), d_model 32, two
Conformer layers and one decoder layer, vocabulary 30, utterances of
0.4–0.5 s, dropout 0, float32. The recipe's weights go into the port
through ``utils/jax_bridge.load_modules``; the data comes from one
manifest of WAV files, read by each side's own pipeline and loader.

Checked: the loss and every gradient of one micro-batch against
``jax.value_and_grad``; four optimizer steps of ``Brain.fit`` with
accumulation 2, clip 5, AdamW and Noam (per micro-batch losses and each
epoch's ``avg_train_loss``); and the parameters after those steps.

Weights come from a numpy seed in the recipe's parameter tree (its shapes
import torch_threads  # noqa: F401  (one torch thread a worker)
from ``jax.eval_shape`` of the recipe's ``init_forward``). The JAX
features come from its unfused ``Fbank``, the port's from the fused one
(on the CPU its plain version): the two differ by about 1e-4 dB
(``tests/test_torch_mel_frontend.py``). Tolerances: losses 1e-4 relative
(read about 1e-6); gradients 1e-3 of each tensor's largest entry, plus
1e-6 for the attention keys' biases, whose gradient is zero up to
rounding; parameters as :func:`test_parameters_after_four_steps_match`
says. The loader runs in order here: shuffled, the two sides draw the same
order (``tests/test_torch_dataio.py``), so the order adds nothing to check.

The Python hyperparameters that ``chip_smoke.py``'s ``recipe_path`` runs
on the card, where there is no YAML loader, are held against the twin's
``hparams/conformer_large.yaml`` loaded by the port's
``load_hyperpyyaml``: every value, and every weight, equal."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from speechbrain_tpu.core import Stage as JaxStage
from speechbrain_tpu.dataio.dataio import read_audio as jax_read_audio
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JaxDataset
from speechbrain_tpu.lobes.features import Fbank as JaxFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JaxFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JaxASR,
)
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.schedulers import NoamScheduler as JaxNoam
from speechbrain_tpu.processing.features import InputNormalization as JaxNorm
from speechbrain_tpu.utils.epoch_loop import EpochCounter as JaxEpochCounter
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter
from speechbrain_tpu_torch.utils.jax_bridge import load_modules

RECIPE = os.path.join(os.path.dirname(__file__), "..", "recipes",
                      "LibriSpeech", "ASR", "transformer")

CFG = dict(
    chip_smoke.TRAIN, vocab=30, n_mels=20, fe_channels=(4, 8), d_model=32,
    nhead=4, enc_layers=2, dec_layers=1, d_ffn=64, kernel_size=5,
    dropout=0.0, n_train=8, n_valid=2, seconds=(0.4, 0.5), n_tokens=(3, 6),
    batch_size=2, sig_multiple=8000, precision="fp32",
)
# one padded shape for every batch: JAX compiles its step once
LOADER = {"batch_size": 2, "pad_to_multiple": {
    "sig": 8000, "tokens": 8, "tokens_bos": 8, "tokens_eos": 8}}
RUN_OPTS = {"grad_accumulation_factor": 2, "max_grad_norm": 5.0,
            "noprogressbar": True}
LOSS_RTOL = 1e-4


def _recipe():
    """The recipe's ``train.py``, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "librispeech_transformer_train", os.path.join(RECIPE, "train.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_params(shapes, seed=0):
    """Weights from a numpy seed in the recipe's tree: kernels and
    embeddings scaled by 1/sqrt(fan-in), layer-norm scales about 1,
    biases about 0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name in ("kernel", "embedding"):
            fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" \
                else leaf.shape[-1]
            return x / np.sqrt(fan_in)
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_dataset(manifest):
    ds = JaxDataset.from_json(manifest).filtered_sorted(sort_key="length")
    ds.add_dynamic_item(jax_read_audio, takes="wav", provides="sig")

    def tokens_pipeline(text):
        ids = [int(t) for t in text.split()]
        yield np.asarray(ids, np.int32)
        yield np.asarray([CFG["bos"]] + ids, np.int32)
        yield np.asarray(ids + [CFG["eos"]], np.int32)

    ds.add_dynamic_item(tokens_pipeline, takes="tokens",
                        provides=["tokens_ids", "tokens_bos", "tokens_eos"])
    ds.set_output_keys({"id": "id", "sig": "sig", "tokens": "tokens_ids",
                        "tokens_bos": "tokens_bos",
                        "tokens_eos": "tokens_eos"})
    return ds


def _jax_brain(losses):
    recipe = _recipe()

    class Recorded(recipe.ASR):
        def on_fit_batch_end(self, batch, outputs, loss, should_step):
            losses.append(float(loss))
            super().on_fit_batch_end(batch, outputs, loss, should_step)

    C = CFG
    n_feat = (C["n_mels"] + 3) // 4 * C["fe_channels"][-1]
    modules = {
        "frontend": JaxFrontEnd(num_blocks=2, out_channels=C["fe_channels"],
                                kernel_sizes=(3, 3), strides=(2, 2),
                                dropout=0.0),
        "model": JaxASR(tgt_vocab=C["vocab"], input_size=n_feat,
                        d_model=C["d_model"], nhead=C["nhead"],
                        num_encoder_layers=C["enc_layers"],
                        num_decoder_layers=C["dec_layers"],
                        d_ffn=C["d_ffn"], dropout=0.0,
                        encoder_module="conformer",
                        attention_type="RelPosMHAXL",
                        kernel_size=C["kernel_size"]),
        "ctc_head": JaxLinear(n_neurons=C["vocab"]),
        "seq_head": JaxLinear(n_neurons=C["vocab"]),
    }
    hparams = {
        "compute_features": JaxFbank(n_mels=C["n_mels"]),
        "normalize": JaxNorm(norm_type="sentence"),
        "ctc_weight": C["ctc_weight"],
        "label_smoothing": C["label_smoothing"],
        "blank_index": C["blank"],
        "noam_scheduler": JaxNoam(lr_initial=C["lr_adam"],
                                  n_warmup_steps=C["n_warmup_steps"]),
    }
    return Recorded(
        modules=modules, hparams=hparams, run_opts=dict(RUN_OPTS),
        opt_class=lambda: optax.inject_hyperparams(optax.adamw)(
            learning_rate=C["lr_adam"]),
    )


def _port_brain(tmp, variables, losses):
    class Recorded(chip_smoke.ASR):
        def on_fit_batch_end(self, batch, outputs, loss, should_step):
            losses.append(float(loss))
            super().on_fit_batch_end(batch, outputs, loss, should_step)

    modules = chip_smoke.make_asr_modules(CFG, device="cpu", dropout=0.0)
    load_modules(modules, variables)
    return Recorded(
        modules=modules, opt_class=chip_smoke.adamw(CFG),
        hparams=chip_smoke.make_asr_hparams(CFG, tmp, device="cpu"),
        run_opts=dict(RUN_OPTS, device="cpu"),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both Brains from the same initial weights; the gradients of the
    first batch; then two epochs of ``fit`` (4 optimizer steps)."""
    tmp = str(tmp_path_factory.mktemp("asr"))
    paths = chip_smoke.write_asr_corpus(CFG, tmp)
    jds = _jax_dataset(paths["train"])
    tds = chip_smoke.asr_dataset(paths["train"], CFG, train=True)
    jax_losses, port_losses = [], []

    jb = _jax_brain(jax_losses)
    from speechbrain_tpu.dataio.dataloader import make_dataloader

    first = next(iter(make_dataloader(jds, **LOADER)))
    jbatch = jb._prepare_batch(first)
    init = _random_params(jax.eval_shape(
        lambda rng: jb.init_forward(rng, jbatch), jax.random.PRNGKey(0)
    )["params"])
    jb.params = jax.tree_util.tree_map(jnp.asarray, init)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jb._loss_and_aux(p, jb.model_state, jbatch,
                                   JaxStage.TRAIN, jb.rng),
        has_aux=True))(jb.params)

    pb = _port_brain(tmp, init, port_losses)
    pb.modules.train()
    batch = next(iter(pb.make_dataloader(tds, Stage.TRAIN,
                                         ckpt_prefix=None, **LOADER)))
    batch = pb._prepare_batch(batch)
    ploss = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                  batch, Stage.TRAIN)
    ploss.backward()
    pgrads = {n: p.grad.clone() for n, p in pb.modules.named_parameters()}
    pb.modules.zero_grad(set_to_none=True)

    jepochs, pepochs = [], []
    for brain, counter, ds, epochs in (
        (jb, JaxEpochCounter(2), jds, jepochs),
        (pb, EpochCounter(2), tds, pepochs),
    ):
        def record(stage, loss, epoch=None, _e=epochs):
            if stage.name == "TRAIN":
                _e.append(loss)
        brain.on_stage_end = record
        brain.fit(counter, ds, train_loader_kwargs=LOADER)

    return {
        "tmp": tmp, "jloss": float(jloss), "ploss": float(ploss.detach()),
        "jgrads": _np_tree(jgrads), "pgrads": pgrads,
        "jax_losses": jax_losses, "port_losses": port_losses,
        "jax_epochs": jepochs, "port_epochs": pepochs,
        "init": init, "jax_params": _np_tree(jb.params), "port": pb,
        "steps": (jb.optimizer_step, pb.optimizer_step),
    }


def _bridged(tree):
    """A port model holding ``tree`` (a JAX parameter tree) as weights:
    the JAX side's values, laid out as the port's parameters."""
    modules = torch.nn.ModuleDict(
        chip_smoke.make_asr_modules(CFG, device="cpu", dropout=0.0)
    )
    load_modules(modules, tree)
    return dict(modules.named_parameters())


def test_one_step_loss_and_every_gradient(runs):
    assert runs["ploss"] == pytest.approx(runs["jloss"], rel=LOSS_RTOL)
    jgrads = _bridged(runs["jgrads"])
    assert set(jgrads) == set(runs["pgrads"])
    for name, g in runs["pgrads"].items():
        ref = jgrads[name].detach()
        tol = 1e-3 * float(ref.abs().max()) + 1e-6
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=0,
                                   atol=tol, err_msg=name)


def test_fit_losses_match(runs):
    assert runs["steps"] == (4, 4)
    assert len(runs["port_losses"]) == len(runs["jax_losses"]) == 8
    np.testing.assert_allclose(runs["port_losses"], runs["jax_losses"],
                               rtol=LOSS_RTOL)
    assert len(runs["port_epochs"]) == len(runs["jax_epochs"]) == 2
    np.testing.assert_allclose(runs["port_epochs"], runs["jax_epochs"],
                               rtol=LOSS_RTOL)


def test_parameters_after_four_steps_match(runs):
    """Each tensor's update (after minus before) within 5e-2 of the JAX
    update in relative L2 norm, and all of them together within 1e-2.
    Adam moves an entry by about the learning rate whatever its gradient's
    size, so an entry whose gradient is at the rounding level (positional
    dimensions that are nearly constant over time; read 1.2e-2 on
    ``pos_proj``) moves by noise. The attention keys' biases have a
    gradient of exactly zero (a softmax ignores a constant added to all of
    a query's scores): their whole update is such noise, held only to what
    two Adam trajectories can drift apart, 3 x the sum of the rates."""
    before = _bridged(runs["init"])
    jparams = _bridged(runs["jax_params"])
    lrs = [CFG["lr_adam"]] + [
        chip_smoke.NoamScheduler(CFG["lr_adam"], CFG["n_warmup_steps"])(k)
        for k in (1, 2, 3)
    ]
    num = den = 0.0
    for name, p in runs["port"].modules.named_parameters():
        dp = p.detach() - before[name].detach()
        dj = jparams[name].detach() - before[name].detach()
        if name.endswith("k_proj.bias"):
            assert float((dp - dj).abs().max()) <= 3 * sum(lrs), name
            continue
        err = float((dp - dj).norm())
        assert err <= 5e-2 * float(dj.norm()), name
        num += err ** 2
        den += float(dj.norm()) ** 2
    assert num ** 0.5 <= 1e-2 * den ** 0.5


def test_load_modules_refuses_a_missing_or_unused_module(runs):
    modules = chip_smoke.make_asr_modules(CFG, device="cpu", dropout=0.0)
    tree = dict(runs["init"])
    with pytest.raises(KeyError, match="seq_head"):
        load_modules(modules, {k: v for k, v in tree.items()
                               if k != "seq_head"})
    with pytest.raises(KeyError, match="lm"):
        load_modules(modules, {**tree, "lm": {}})
    tree["ctc_head"] = {**tree["ctc_head"], "extra": np.zeros(1)}
    with pytest.raises(KeyError, match="extra"):
        load_modules(modules, tree)


class _Regression(chip_smoke.Brain):
    """A linear model on ``(x, y)`` batches; ``bad`` micro-batches give a
    loss that is not finite."""

    bad = ()

    def compute_forward(self, batch, stage):
        return self.modules.lin(batch["x"].data)

    def compute_objectives(self, predictions, batch, stage):
        loss = ((predictions - batch["y"].data) ** 2).mean()
        if stage == Stage.TRAIN and self._micro_step in self.bad:
            loss = loss * float("inf")
        return loss


def _regression_data(n=8):
    rng = np.random.default_rng(0)
    return [{"x": rng.standard_normal(3).astype(np.float32),
             "y": rng.standard_normal(2).astype(np.float32)}
            for _ in range(n)]


def _regression_brain(tmp_path=None, **run_opts):
    from speechbrain_tpu_torch.utils.checkpoints import Checkpointer

    torch.manual_seed(0)
    ckpt = Checkpointer(tmp_path) if tmp_path is not None else None
    return _Regression(
        modules={"lin": torch.nn.Linear(3, 2)},
        opt_class=lambda p: torch.optim.SGD(p, lr=0.1),
        run_opts={"device": "cpu", "noprogressbar": True,
                  "grad_accumulation_factor": 2, "max_grad_norm": 0.0,
                  **run_opts},
        checkpointer=ckpt,
    )


def test_a_nonfinite_micro_batch_changes_nothing_then_patience_ends():
    """Micro-batch 1 of 4 is not finite: the window holds only micro-batch
    0 until micro-batch 2 fills it, so the one applied update is the mean
    of micro-batches 0 and 2. More non-finite losses than the patience
    stop the fit."""
    data = _regression_data(4)
    ref = _regression_brain()
    ref.init_optimizers()
    brain = _regression_brain()
    brain.bad = (1,)
    brain.fit(EpochCounter(1), data, train_loader_kwargs={"batch_size": 1})
    lin = ref.modules.lin
    grads = []
    for i in (0, 2):
        lin.zero_grad()
        x, y = (torch.from_numpy(data[i][k])[None] for k in ("x", "y"))
        ((lin(x) - y) ** 2).mean().backward()
        grads.append([p.grad.clone() for p in lin.parameters()])
    with torch.no_grad():
        for p, g0, g2 in zip(lin.parameters(), *grads):
            p -= 0.1 * (g0 + g2) / 2
    assert brain.optimizer_step == 2  # counted as the JAX package counts
    assert brain._window_count == 1  # micro-batch 3 waits in the window
    for p, q in zip(brain.modules.lin.parameters(), lin.parameters()):
        torch.testing.assert_close(p, q)

    stubborn = _regression_brain(nonfinite_patience=1)
    stubborn.bad = (0, 1, 2)
    with pytest.raises(ValueError, match="patience"):
        stubborn.fit(EpochCounter(1), data,
                     train_loader_kwargs={"batch_size": 1})


def test_intra_epoch_checkpoints_keep_one(tmp_path):
    brain = _regression_brain(tmp_path, ckpt_interval_steps=1)
    brain.fit(EpochCounter(1), _regression_data(6),
              train_loader_kwargs={"batch_size": 1})
    ckpts = brain.checkpointer.list_checkpoints()
    assert len(ckpts) == 1
    assert ckpts[0].meta["brain_intra_epoch_ckpt"] is True
    assert ckpts[0].meta["end-of-epoch"] is False


def _same(a, b, path="hparams"):
    """``a`` and ``b`` hold the same values: plain values equal, tensors
    equal bit for bit, containers and objects (their attributes) alike
    throughout."""
    assert type(a) is type(b), path
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dict__") and not isinstance(
            a, (type, types.FunctionType, types.MethodType)):
        _same(vars(a), vars(b), f"{path}.")
    else:
        assert a == b, path


def test_recipe_path_hparams_are_the_yaml(tmp_path):
    """``chip_smoke.recipe_hparams`` (what ``recipe_path`` runs on the
    card) against the twin's ``conformer_large.yaml`` loaded with the same
    overrides, the cuts of ``recipe_path`` included: the same keys, plain
    values, objects and modules, the weights bit for bit (both draw them
    after ``seed_everything(3407)`` in the same order), on the CPU."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    overrides = dict(chip_smoke.RECIPE_OVERRIDES, device="cpu",
                     data_folder=str(tmp_path / "data"),
                     output_folder=str(tmp_path / "out"))
    yaml_path = os.path.join(os.path.dirname(chip_smoke.recipe.__file__),
                             "hparams", "conformer_large.yaml")
    with open(yaml_path) as f:
        from_yaml = load_hyperpyyaml(f, overrides)
    from_python = chip_smoke.recipe_hparams(overrides)
    assert from_python["d_model"] == 512
    assert from_python["num_encoder_layers"] == 12
    assert from_python["number_of_epochs"] == 3
    assert from_python["compute_features"].fused
    _same(from_python, from_yaml)
