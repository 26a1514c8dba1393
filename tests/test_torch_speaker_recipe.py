"""The speaker family's twins against the JAX package's recipes, each
imported as it is, at a small size:

* ``recipes/VoxCeleb/SpeakerRec``: ``prepare_synthetic`` against JAX's
  (manifests and WAV files), the same random crops as JAX's for the same
  seed and order of reads, one epoch of the ECAPA twin from its YAML
  against the JAX script from its YAML (the same initial weights, drawn
  with numpy in the JAX tree and bridged; the first loss within 1e-4
  relative: float32 on both sides, the JAX YAML's unfused Fbank against
  the twin's fused one, whose CPU arm is B3's plain version, up to 3e-3
  dB apart), its checkpoint, and an EER from the verification script on
  the checkpointed model;
* ``templates/speaker_id``: two epochs of the twin against the JAX
  template (label file byte for byte, the first loss within 1e-4
  relative), and the twin run as a user runs it (``python -m ...``, in a
  subprocess started before the first test), its export served by
  ``EncoderClassifier.from_hparams`` with the best checkpoint's weights;
* every twin YAML's values against the JAX YAML's, read as text;
* three faults of the reference that the twins do not copy (ROADMAP
  C38-C40), each shown on the JAX package;
* ``chip_smoke.py``'s ``speaker_path`` run on the CPU at a small size
  (``torch.cuda``'s timing calls stubbed, the fused Fbank's plain version
  counted as its launches)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from speechbrain_tpu.dataio.encoder import CategoricalEncoder as JaxEncoder
from speechbrain_tpu.lobes.models.ResNet import ResNet as JaxResNet
from speechbrain_tpu.lobes.models.Xvector import Xvector as JaxXvector
from speechbrain_tpu.nnet.losses import nll_loss as jax_nll_loss
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.dataio.encoder import CategoricalEncoder
from speechbrain_tpu_torch.inference.classifiers import EncoderClassifier
from speechbrain_tpu_torch.ops import mel_frontend
from speechbrain_tpu_torch.recipes.Google_speech_commands.command_recognition import (  # noqa: E501
    prepare as gsc_prepare,
)
from speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec import (
    prepare as vox_prepare,
)
from speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec import (
    speaker_verification_cosine as verify,
)
from speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec import (
    train_speaker_embeddings as vox,
)
from speechbrain_tpu_torch.templates.speaker_id import train as template
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load_modules
from test_torch_rnn import draw_from_shapes
from test_torch_seq2seq_recipe import _scalars

ROOT = Path(__file__).resolve().parent.parent
JAX_VOX = ROOT / "recipes" / "VoxCeleb" / "SpeakerRec"
TWIN_VOX = ROOT / "speechbrain_tpu_torch" / "recipes" / "VoxCeleb" / \
    "SpeakerRec"
JAX_GSC = ROOT / "recipes" / "Google-speech-commands" / "command_recognition"
TWIN_GSC = ROOT / "speechbrain_tpu_torch" / "recipes" / \
    "Google_speech_commands" / "command_recognition"
JAX_TEMPLATE = ROOT / "templates" / "speaker_id"
TWIN_TEMPLATE = ROOT / "speechbrain_tpu_torch" / "templates" / "speaker_id"
LOSS_RTOL = 1e-4
SR = 16000
# the widths the tests cut the YAMLs to (text replacements: the YAMLs
# write their channels as literals)
TINY_ECAPA = ("channels: !tuple (1024, 1024, 1024, 1024, 3072)",
              "channels: !tuple (16, 16, 16, 16, 48)")
TINY_TEMPLATE = ("channels: !tuple (128, 128, 128, 128, 384)",
                 "channels: !tuple (16, 16, 16, 16, 48)")


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _edited(path, *edits):
    text = Path(path).read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def _recording(cls, losses):
    """``cls`` recording each micro-batch's loss (``"steps"``) and each
    epoch's ``(train, valid)`` loss (``"epochs"``) into ``losses``."""
    losses.update(steps=[], epochs=[])

    class Recorded(cls):
        def on_fit_batch_end(self, batch, outputs, loss, should_step):
            losses["steps"].append(float(np.asarray(
                loss.detach() if hasattr(loss, "detach") else loss)))
            super().on_fit_batch_end(batch, outputs, loss, should_step)

        def on_stage_end(self, stage, stage_loss, epoch=None):
            if stage.name == "VALID":
                losses["epochs"].append((float(self.train_loss),
                                         float(stage_loss)))
            super().on_stage_end(stage, stage_loss, epoch)
    return Recorded


def _held_to_jax(port, jax_losses, steps):
    """The first micro-batch's float32 loss within 1e-4 relative of
    JAX's; both ran ``steps`` micro-batches and every epoch, with finite
    losses. The later losses are not held to JAX's: Adam's first update
    is lr times the sign of each gradient, so a gradient near zero whose
    float32 sign differs between the packages moves its weight by twice
    lr, and the runs part (by 5e-4 to 1e-3 relative after two steps at
    this size)."""
    assert len(port["steps"]) == len(jax_losses["steps"]) == steps
    assert port["steps"][0] == pytest.approx(jax_losses["steps"][0],
                                             rel=LOSS_RTOL)
    assert len(port["epochs"]) == len(jax_losses["epochs"]) >= 1
    assert np.isfinite(port["steps"] + jax_losses["steps"]).all()
    assert np.isfinite(port["epochs"] + jax_losses["epochs"]).all()


def _jax_variables(brain, batch_size, samples):
    """Weights from numpy in the shapes of the JAX Brain's
    ``init_forward`` on a zero batch (no data is read, so no crop is
    drawn)."""
    fake = {"sig": (jnp.zeros((batch_size, samples)), jnp.ones(batch_size))}
    shapes = jax.eval_shape(lambda rng: brain.init_forward(rng, fake),
                            jax.random.PRNGKey(0))
    return draw_from_shapes(shapes, seed=3)


def _start(brain, variables):
    brain.params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    brain.model_state = {"batch_stats": jax.tree_util.tree_map(
        jnp.asarray, variables["batch_stats"])}


# -- data preparation and crops ---------------------------------------------

@pytest.mark.parametrize("recipe", ["voxceleb", "speech_commands"])
def test_prepare_synthetic_matches_jax(recipe, tmp_path):
    if recipe == "voxceleb":
        jax_prep = _load_script(JAX_VOX / "prepare.py", "jax_vox_prepare")
        jax_prep.prepare_synthetic(tmp_path / "jax")
        vox_prepare.prepare_synthetic(tmp_path / "torch")
        manifests = ("train.json", "dev.json")
    else:
        jax_prep = _load_script(JAX_GSC / "prepare.py", "jax_gsc_prepare")
        jax_prep.prepare_synthetic(tmp_path / "jax")
        gsc_prepare.prepare_synthetic(tmp_path / "torch")
        manifests = ("train.json", "valid.json")
    for name in manifests:
        j = json.loads((tmp_path / "jax" / name).read_text())
        t = json.loads((tmp_path / "torch" / name).read_text())
        assert list(j) == list(t)
        for key in j:
            jw, tw = Path(j[key].pop("wav")), Path(t[key].pop("wav"))
            assert j[key] == t[key]
            assert jw.relative_to(tmp_path / "jax") == tw.relative_to(
                tmp_path / "torch")
            assert jw.read_bytes() == tw.read_bytes()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The VoxCeleb twin's synthetic corpus (4 speakers, 1.2 s
    utterances) with its trials file."""
    data = tmp_path_factory.mktemp("vox_data")
    vox_prepare.prepare_synthetic(data, save_folder=data / "manifests")
    vox_prepare.write_trials(data, [data / "manifests" / "train.json",
                                    data / "manifests" / "dev.json"])
    return data


def _crop_hparams(data, save, encoder):
    return {"label_encoder": encoder, "sentence_len": 0.5,
            "sample_rate": SR, "seed": 1986, "data_folder": str(data),
            "save_folder": str(save),
            "train_annotation": str(data / "manifests" / "train.json"),
            "valid_annotation": str(data / "manifests" / "dev.json")}


def test_random_crops_match_jax(corpus, tmp_path):
    """Two passes over the train split and one over the valid split, in
    one order: every crop (0.5 s of 1.2 s) equals JAX's."""
    jax_script = _load_script(JAX_VOX / "train_speaker_embeddings.py",
                              "jax_vox_train_crops")
    j = jax_script.dataio_prepare(
        _crop_hparams(corpus, tmp_path / "j", JaxEncoder()))
    t = vox.dataio_prepare(
        _crop_hparams(corpus, tmp_path / "t", CategoricalEncoder()))
    assert (tmp_path / "j" / "label_encoder.txt").read_bytes() == (
        tmp_path / "t" / "label_encoder.txt").read_bytes()
    n = 0
    for split in ("train", "train", "valid"):
        for i in range(len(j[split])):
            a, b = j[split][i], t[split][i]
            assert a["id"] == b["id"]
            assert int(a["spk_id_encoded"]) == int(b["spk_id_encoded"])
            assert len(b["sig"]) == SR // 2
            np.testing.assert_array_equal(np.asarray(a["sig"]), b["sig"])
            n += 1
    assert n == 8 + 8 + 4


# -- the VoxCeleb ECAPA twin against the JAX script --------------------------

def _vox_overrides(corpus, out):
    return {"data_folder": str(corpus), "output_folder": str(out),
            "train_annotation": str(corpus / "manifests" / "train.json"),
            "valid_annotation": str(corpus / "manifests" / "dev.json"),
            "n_classes": 4, "emb_dim": 12, "batch_size": 4,
            "number_of_epochs": 1, "sentence_len": 0.5}


@pytest.fixture(scope="module")
def vox_runs(corpus, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vox_runs")
    jax_script = _load_script(JAX_VOX / "train_speaker_embeddings.py",
                              "jax_vox_train")
    jh = jax_load(_edited(JAX_VOX / "hparams" / "train_ecapa_tdnn.yaml",
                          TINY_ECAPA),
                  _vox_overrides(corpus, tmp / "jax"))
    os.makedirs(jh["save_folder"], exist_ok=True)
    jdatasets = jax_script.dataio_prepare(jh)
    jax_losses = {}
    jb = _recording(jax_script.SpeakerBrain, jax_losses)(
        modules=jh["modules"],
        opt_class=lambda: optax.inject_hyperparams(optax.adam)(
            learning_rate=jh["lr"]),
        hparams=jh, run_opts={"noprogressbar": True},
        checkpointer=jh["checkpointer"])
    variables = _jax_variables(jb, 4, SR // 2)
    _start(jb, variables)
    jb.fit(jh["epoch_counter"], jdatasets["train"], jdatasets["valid"],
           train_loader_kwargs={"batch_size": 4, "shuffle": True},
           valid_loader_kwargs={"batch_size": 4})

    th = load_hyperpyyaml(
        _edited(TWIN_VOX / "hparams" / "train_ecapa_tdnn.yaml", TINY_ECAPA),
        dict(_vox_overrides(corpus, tmp / "torch"), device="cpu"))
    load_modules(th["modules"], jax.tree_util.tree_map(np.asarray,
                                                       variables))
    port_losses = {}
    brain = vox.run(th, {"device": "cpu", "noprogressbar": True},
                    brain_cls=_recording(vox.SpeakerBrain, port_losses))
    return {"jax": jax_losses, "torch": port_losses, "jb": jb,
            "brain": brain, "th": th, "tmp": tmp}


def test_voxceleb_ecapa_epoch_matches_the_jax_script(vox_runs):
    """One epoch (2 steps of 4 crops, shuffled) and the valid stage: the
    first loss within 1e-4 relative of JAX's (``_held_to_jax``), the
    cyclic rate set from the optimizer step at the valid stage, one
    checkpoint. (At 2 crops a batch the two packages' training-mode
    BatchNorms, E[x^2] - E[x]^2 in float32 over the 2 rows of the pooled
    statistics, already lie up to 5e-4 apart: each package's own float32
    noise; hence 4.)"""
    _held_to_jax(vox_runs["torch"], vox_runs["jax"], steps=2)
    brain = vox_runs["brain"]
    assert brain.optimizer_step == vox_runs["jb"].optimizer_step == 2
    assert brain.optimizer.param_groups[0]["lr"] == pytest.approx(
        vox_runs["th"]["lr_scheduler"](2))
    ckpts = brain.checkpointer.list_checkpoints()
    assert len(ckpts) == 1
    assert {"embedding_model", "classifier", "modules"} <= set(
        ckpts[0].paramfiles)


def test_verification_script_scores_the_checkpoint_to_an_eer(vox_runs,
                                                             corpus):
    """The twin's verification YAML (cut to the trained widths) loads the
    run's checkpointed embedding model and scores the 66 trials of the
    corpus: cosine and PLDA, an EER and a minDCF each."""
    overrides = {"output_folder": str(vox_runs["tmp"] / "torch"),
                 "data_folder": str(corpus), "emb_dim": 12,
                 "device": "cpu"}
    h = load_hyperpyyaml(_edited(
        TWIN_VOX / "hparams" / "verification_ecapa.yaml", TINY_ECAPA),
        overrides)
    result = verify.score_trials(h, "cpu")
    assert len(result["scores"]) == 66 and result["labels"].sum() == 12
    assert 0.0 <= result["eer"] <= 1.0 and np.isfinite(result["min_dcf"])
    trained = vox_runs["brain"].modules.embedding_model.state_dict()
    for k, v in h["embedding_model"].state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=0)
    # PLDA over the same embeddings (scoring: plda, rank 4)
    h["scoring"], h["plda_rank_f"] = "plda", 4
    h["plda_train_annotation"] = str(corpus / "manifests" / "train.json")
    plda = verify.score_trials(h, "cpu")
    assert np.isfinite(plda["scores"]).all() and 0.0 <= plda["eer"] <= 1.0


# -- the speaker_id template against the JAX template -------------------------

TEMPLATE_OVERRIDES = {"n_classes": 4, "emb_dim": 12, "batch_size": 4,
                      "number_of_epochs": 2}


def _template_data(corpus):
    """The corpus's manifests under the names the template reads."""
    data = corpus / "template"
    data.mkdir(exist_ok=True)
    for split, src in (("train", "train"), ("valid", "dev")):
        (data / f"{split}.json").write_text(
            (corpus / "manifests" / f"{src}.json").read_text())
    return data


@pytest.fixture(scope="module", autouse=True)
def template_cli(corpus, tmp_path_factory):
    """The template twin's ``train.py`` in a subprocess, as a user runs
    it, on a copy of the template folder cut to a small width."""
    tmp = tmp_path_factory.mktemp("speaker_id_cli")
    for name in ("train.yaml", "inference.yaml"):
        (tmp / name).write_text(_edited(TWIN_TEMPLATE / name, TINY_TEMPLATE))
    flags = [f"--{k}={v}" for k, v in TEMPLATE_OVERRIDES.items()]
    code = ("import sys; from pathlib import Path; "
            "from speechbrain_tpu_torch.templates.speaker_id import train; "
            f"train.INFERENCE_YAML = Path({str(tmp / 'inference.yaml')!r}); "
            "train.main(sys.argv[1:])")
    cmd = [sys.executable, "-c", code, str(tmp / "train.yaml"),
           f"--data_folder={_template_data(corpus)}",
           f"--output_folder={tmp}/out", "--device=cpu",
           "--noprogressbar"] + flags
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield tmp, proc
    finally:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def template_runs(corpus, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("speaker_id")
    data = _template_data(corpus)
    overrides = dict(TEMPLATE_OVERRIDES, data_folder=str(data))
    jax_template = _load_script(JAX_TEMPLATE / "train.py",
                                "jax_speaker_id_template")
    jh = jax_load(_edited(JAX_TEMPLATE / "train.yaml", TINY_TEMPLATE),
                  dict(overrides, output_folder=str(tmp / "jax")))
    os.makedirs(jh["save_folder"], exist_ok=True)
    jdatasets = jax_template.dataio_prep(jh)
    jax_losses = {}
    jb = _recording(jax_template.SpeakerBrain, jax_losses)(
        modules=jh["modules"], opt_class=lambda: optax.adam(jh["lr"]),
        hparams=jh, run_opts={"noprogressbar": True},
        checkpointer=jh["checkpointer"])
    variables = _jax_variables(jb, 4, 20480)
    _start(jb, variables)
    loader = {"batch_size": 4, "pad_to_multiple": template.SIG_PAD_MULTIPLE}
    jb.fit(jh["epoch_counter"], jdatasets["train"], jdatasets["valid"],
           train_loader_kwargs=dict(loader, shuffle=True),
           valid_loader_kwargs=loader)

    th = load_hyperpyyaml(_edited(TWIN_TEMPLATE / "train.yaml",
                                  TINY_TEMPLATE),
                          dict(overrides, output_folder=str(tmp / "torch"),
                               device="cpu"))
    load_modules(th["modules"], jax.tree_util.tree_map(np.asarray,
                                                       variables))
    port_losses = {}
    small = tmp / "inference.yaml"
    small.write_text(_edited(TWIN_TEMPLATE / "inference.yaml",
                             TINY_TEMPLATE))
    saved, template.INFERENCE_YAML = template.INFERENCE_YAML, small
    try:
        brain = template.run(th, {"device": "cpu", "noprogressbar": True},
                             brain_cls=_recording(template.SpeakerBrain,
                                                  port_losses))
    finally:
        template.INFERENCE_YAML = saved
    return {"jax": jax_losses, "torch": port_losses, "jh": jh, "th": th,
            "brain": brain}


def test_speaker_id_label_files_equal(template_runs):
    names = [Path(h["save_folder"]) / "label_encoder.txt"
             for h in (template_runs["jh"], template_runs["th"])]
    assert names[0].read_bytes() == names[1].read_bytes()


def test_speaker_id_first_loss_matches_the_jax_template(template_runs):
    """Two epochs of two steps: the first loss within 1e-4 relative of
    JAX's (``_held_to_jax``), and the twin's train loss falls."""
    _held_to_jax(template_runs["torch"], template_runs["jax"], steps=4)
    assert template_runs["brain"].optimizer_step == 4
    epochs = template_runs["torch"]["epochs"]
    assert len(epochs) == 2 and epochs[1][0] < epochs[0][0]


def test_speaker_id_export_is_served_by_from_hparams(template_runs, corpus,
                                                     tmp_path):
    """The export of the in-process run: ``EncoderClassifier.from_hparams``
    holds the trained modules bit for bit and classifies as they do."""
    th, brain = template_runs["th"], template_runs["brain"]
    served = EncoderClassifier.from_hparams(
        source=th["pretrained_folder"], savedir=tmp_path / "served",
        run_opts={"device": "cpu"})
    for name in ("embedding_model", "classifier"):
        mine = getattr(brain.modules, name).state_dict()
        for k, v in getattr(served.mods, name).state_dict().items():
            torch.testing.assert_close(v, mine[k], rtol=0, atol=0)
    wav = next(iter(json.loads(
        (corpus / "manifests" / "dev.json").read_text()).values()))["wav"]
    out_prob, _, index, labels = served.classify_file(wav)
    brain.modules.eval()
    with torch.no_grad():
        sig = served.load_audio(wav)[None]
        ref = brain.modules.classifier(brain.modules.embedding_model(
            th["compute_features"](sig)))
    torch.testing.assert_close(out_prob, ref, rtol=0, atol=1e-6)
    assert labels == [th["label_encoder"].decode_ind(int(index[0]))]


def test_speaker_id_cli_run_exports_what_it_trained(template_cli, corpus):
    tmp, proc = template_cli
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    log = (tmp / "out" / "train_log.txt").read_text()
    assert len(re.findall(r"train loss", log)) == 2
    folder = tmp / "out" / "pretrained"
    assert {"embedding_model.ckpt", "classifier.ckpt", "label_encoder.ckpt",
            "hyperparams.yaml"} <= {p.name for p in folder.iterdir()}
    served = EncoderClassifier.from_hparams(
        source=folder, savedir=tmp / "served", run_opts={"device": "cpu"})
    wav = next(iter(json.loads(
        (corpus / "manifests" / "dev.json").read_text()).values()))["wav"]
    _, score, _, labels = served.classify_file(wav)
    assert torch.isfinite(score).all() and labels[0].startswith("spk")


# -- the twin YAMLs against the JAX YAMLs ------------------------------------

YAML_PAIRS = {
    "vox_train_ecapa": (JAX_VOX, TWIN_VOX, "hparams/train_ecapa_tdnn.yaml",
                        {}),
    "vox_train_xvector": (JAX_VOX, TWIN_VOX, "hparams/train_xvector.yaml",
                          {}),
    "vox_train_resnet": (JAX_VOX, TWIN_VOX, "hparams/train_resnet.yaml", {}),
    "vox_verification_ecapa": (JAX_VOX, TWIN_VOX,
                               "hparams/verification_ecapa.yaml", {}),
    # C38: the widths the x-vector YAML trains
    "vox_verification_plda_xvector": (
        JAX_VOX, TWIN_VOX, "hparams/verification_plda_xvector.yaml",
        {"emb_dim": (192, 512)}),
    # C39: the ResNet YAML's trained widths
    "vox_verification_resnet": (
        JAX_VOX, TWIN_VOX, "hparams/verification_resnet.yaml",
        {"emb_dim": (192, 256),
         "resnet_channels": ([32, 64, 128, 256], [128, 128, 256, 256])}),
    "gsc_xvector": (JAX_GSC, TWIN_GSC, "hparams/xvector.yaml", {}),
    "gsc_ecapa": (JAX_GSC, TWIN_GSC, "hparams/ecapa.yaml", {}),
    "gsc_xvect_leaf": (JAX_GSC, TWIN_GSC, "hparams/xvect_leaf.yaml", {}),
    "speaker_id": (JAX_TEMPLATE, TWIN_TEMPLATE, "train.yaml", {}),
}


@pytest.mark.parametrize("pair", list(YAML_PAIRS))
def test_twin_yaml_values_are_the_jax_yamls(pair):
    """Every top-level scalar of the JAX YAML is the twin's (the twin adds
    ``device``; the widths of C38 and C39 differ); every
    Fbank the twin builds is fused; the literal widths match."""
    jax_root, twin_root, rel, differ = YAML_PAIRS[pair]
    j, t = _scalars(jax_root / rel), _scalars(twin_root / rel)
    t.pop("device", None)
    for key, (jv, tv) in differ.items():
        assert (j.pop(key), t.pop(key)) == (jv, tv), key
    assert t == j
    text = (twin_root / rel).read_text()
    for fbank in re.findall(r"Fbank\n((?:  .*\n)+)", text):
        assert "fused: True" in fbank
    tuples = re.findall(r"!tuple \([^)]*\)", (jax_root / rel).read_text())
    assert tuples == re.findall(r"!tuple \([^)]*\)", text)


# -- faults of the reference the twins do not copy ---------------------------

def test_c38_jax_plda_verification_cannot_load_the_trained_xvector():
    """``verification_plda_xvector.yaml`` builds Xvector(lin_neurons=192);
    ``train_xvector.yaml`` trains 512, and flax refuses the trained
    embedding layer."""
    vy = _scalars(JAX_VOX / "hparams" / "verification_plda_xvector.yaml")
    ty = _scalars(JAX_VOX / "hparams" / "train_xvector.yaml")
    assert (vy["emb_dim"], ty["emb_dim"]) == (192, 512)
    x = jnp.ones((2, 30, 80))
    small = dict(tdnn_channels=(8, 8, 8, 8, 15))
    trained = JaxXvector(lin_neurons=ty["emb_dim"], **small).init(
        jax.random.PRNGKey(0), x, train=False)
    with pytest.raises(Exception, match="embedding"):
        JaxXvector(lin_neurons=vy["emb_dim"], **small).apply(
            trained, x, train=False)


def test_c39_jax_verification_resnet_yaml_does_not_build(tmp_path):
    """``verification_resnet.yaml`` passes ResNet an ``embedding_dim``,
    which it does not take (and names other widths than
    ``train_resnet.yaml``)."""
    with pytest.raises(TypeError, match="embedding_dim"):
        jax_load((JAX_VOX / "hparams" / "verification_resnet.yaml")
                 .read_text(), {"output_folder": str(tmp_path),
                                "data_folder": str(tmp_path)})
    with pytest.raises(TypeError, match="embedding_dim"):
        JaxResNet(embedding_dim=192)


def test_c40_jax_speech_commands_ecapa_objective_raises():
    """The JAX script takes ``[:, 0]`` of the classifier's output: the
    ECAPA classifier's is (batch, classes), so that is one cosine a row,
    and ``nll_loss`` raises on it."""
    cos = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (4, 6)),
                      jnp.float32)
    with pytest.raises(ValueError):
        jax_nll_loss(cos[:, 0], jnp.array([0, 1, 2, 3]))


# -- chip_smoke's speaker_path ------------------------------------------------

def test_speaker_path_configuration_is_the_yamls():
    for name, yaml in chip_smoke.SPEAKER_TWINS.items():
        assert (TWIN_VOX / "hparams" / yaml).exists()
    for yaml in chip_smoke.SPEAKER_VERIFY.values():
        assert (TWIN_VOX / "hparams" / yaml).exists()
    ecapa = _scalars(TWIN_VOX / "hparams" / "train_ecapa_tdnn.yaml")
    gsc = _scalars(TWIN_GSC / "hparams" / "ecapa.yaml")
    assert chip_smoke.SPEAKER_B3_SHAPES == (
        (ecapa["batch_size"], int(ecapa["sentence_len"] * SR),
         ecapa["n_mels"]),
        (gsc["batch_size"], SR, gsc["n_mels"]))
    assert chip_smoke.SPEAKER_YAML_EDITS == []


class _Event:
    """``torch.cuda.Event`` on the host's clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_run_speaker_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's speaker path end to end at a small size: every phase's
    checks hold, and B3 (its plain version, counted) runs once an encode
    and once a batch, never under LEAF."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "SPEAKER_YAML_EDITS", [
        TINY_ECAPA, TINY_TEMPLATE, ("n_classes: 7205", "n_classes: 20"),
        ("batch_size: 32", "batch_size: 4"),
        ("tdnn_channels: [512, 512, 512, 512, 1500]",
         "tdnn_channels: [16, 16, 16, 16, 30]"),
        ("resnet_channels: [128, 128, 256, 256]",
         "resnet_channels: [4, 4, 8, 8]"),
        ("resnet_layers: [3, 4, 6, 3]", "resnet_layers: [1, 1, 1, 1]"),
        ("emb_dim: 512", "emb_dim: 32"), ("plda_rank_f: 100",
                                          "plda_rank_f: 10")])
    monkeypatch.setattr(chip_smoke, "SPEAKER_CORPUS", dict(
        speakers=4, train_per_speaker=2, dev_per_speaker=2,
        seconds=(3.2, 3.6)))
    monkeypatch.setattr(chip_smoke, "SPEAKER_SERVE", dict(
        pairs=3, seconds=(3.0, 3.9), padded_seconds=4.0, threshold=0.25,
        repeats=1))
    monkeypatch.setattr(chip_smoke, "SPEAKER_B3_SHAPES",
                        ((2, 48000, 80), (2, 16000, 24)))
    small = tmp_path / "inference.yaml"
    small.write_text(_edited(TWIN_TEMPLATE / "inference.yaml",
                             TINY_TEMPLATE))
    monkeypatch.setattr(template, "INFERENCE_YAML", small)
    reference = mel_frontend.fused_fbank_reference
    arm = mel_frontend._fused_fbank_cuda

    def counted(*args):
        # the kernel's stand-in: counted unless plain_versions swapped it
        if mel_frontend._fused_fbank_cuda is arm:
            mel_frontend.launches += 1
        return reference(*args)

    monkeypatch.setattr(mel_frontend, "fused_fbank_reference", counted)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    launches, b3 = chip_smoke.run_speaker_path(str(tmp_path / "speaker"),
                                               device="cpu")
    by_phase = {line["phase"]: line for line in lines}
    for phase, line in by_phase.items():
        assert line.get("ok", True), (phase, line)
    assert launches == {
        "verify_batch": 2, "classify_batch": 1, "train_ecapa": 4,
        "train_xvector": 4, "train_resnet": 4,
        # one a dev utterance; PLDA also embeds the train split
        "verify_ecapa": 8, "verify_xvector": 16,
        "speech_commands_ecapa": 3, "speech_commands_xvect_leaf": 0,
        "speaker_id_train": 2, "speaker_id_serve": 2}
    assert set(b3) == {"2x48000@80", "2x16000@24"}
    train = by_phase["speaker_train/ecapa"]
    assert train["batch_shape"] == [4, 48000]
    assert train["forwards"] == {"TRAIN": 2, "VALID": 2}
    assert by_phase["speaker_verify/xvector"]["scoring"] == "plda"
    assert by_phase["speaker_path/speaker_id"]["label"][0].startswith("spk")
