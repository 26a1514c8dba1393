"""Exporting a trained model as a ``Pretrained.from_hparams`` source (port
of ``speechbrain_tpu/utils/pretrained.py`` ``save_for_pretrained``; and
``export_classifier``, ``export_separator``, ``export_enhancer`` and
``export_frame_model``, the classification, separation, enhancement and
frame-level (VAD, emotion diarization) twins' exports from their own
training YAML)."""

import re
import shutil
from pathlib import Path


def save_for_pretrained(hparams, min_key=None, max_key=None,
                        ckpt_predicate=None, pretrainer_key="pretrainer",
                        checkpointer_key="checkpointer"):
    """Copy the best checkpoint's ``<name>.ckpt`` of every loadable of
    ``hparams[pretrainer_key]`` to that loadable's path in the
    pretrainer. The checkpointer names its files by its recoverables, so
    the pretrainer's loadables take the same names. A loadable with no
    file in the checkpoint is skipped; one with no path stays where it
    is. Raises when ``hparams`` lacks either object or there is no
    checkpoint."""
    if pretrainer_key not in hparams:
        raise ValueError(
            f"hparams must contain a pretrainer under {pretrainer_key!r}"
        )
    if checkpointer_key not in hparams:
        raise ValueError(
            f"hparams must contain a checkpointer under {checkpointer_key!r}"
        )
    pretrainer = hparams[pretrainer_key]
    ckpt = hparams[checkpointer_key].find_checkpoint(
        min_key=min_key, max_key=max_key, ckpt_predicate=ckpt_predicate
    )
    if ckpt is None:
        raise RuntimeError("no checkpoint found to export")
    for name in pretrainer.loadables:
        src = Path(ckpt.path) / f"{name}.ckpt"
        if not src.exists():
            continue
        dst = Path(pretrainer.paths.get(name, src))
        dst.parent.mkdir(parents=True, exist_ok=True)
        if src != dst:
            shutil.copy(src, dst)


# top-level keys of a training YAML that serving does not build
TRAINING_KEYS = ("output_folder", "save_folder", "train_log", "data_folder",
                 "train_annotation", "valid_annotation", "test_annotation",
                 "epoch_counter", "train_logger", "checkpointer",
                 "pretrained_folder", "pretrainer", "lr_annealing",
                 "compute_cost")
# the modules a classification export serves
SERVED_MODULES = ("embedding_model", "classifier")


def _serving_lines(yaml_text, overrides, drop=TRAINING_KEYS):
    """The lines of a training YAML after the run's overrides
    (``resolve_yaml``), less its top-level blocks named in ``drop``."""
    from speechbrain_tpu_torch.utils.hyperyaml import resolve_yaml

    kept, keep = [], True
    for line in resolve_yaml(yaml_text, overrides).splitlines():
        key = re.match(r"^(\w+)\s*:", line)
        if key:
            keep = key.group(1) not in drop
        if keep:
            kept.append(line)
    return kept


def _pretrainer_lines(names):
    return (["", "pretrainer: !new:speechbrain_tpu_torch.utils."
             "parameter_transfer.Pretrainer", "  loadables:"]
            + [f"    {name}: !ref <modules[{name}]>" for name in names])


def served_hparams_text(yaml_text, overrides=None):
    """A training YAML as the ``hyperparams.yaml`` of its export: the
    run's overrides applied (``resolve_yaml``), the top-level blocks of
    ``TRAINING_KEYS`` taken out, and a ``pretrainer`` appended whose
    loadables are the ``SERVED_MODULES`` of the YAML's ``modules`` and its
    ``label_encoder`` (each read from ``<name>.ckpt`` of the source)."""
    kept = _serving_lines(yaml_text, overrides)
    kept += _pretrainer_lines(SERVED_MODULES)
    kept.append("    label_encoder: !ref <label_encoder>")
    return "\n".join(kept) + "\n"


# the modules of a separation export: the whole wrapper as ``masknet``,
# or its three parts (the upstream checkpoint's layout)
SEPARATOR_MODULES = {
    False: {"masknet": "model"},
    True: {"encoder": "model.encoder", "masknet": "model.masknet",
           "decoder": "model.decoder"},
}


def separator_hparams_text(yaml_text, overrides=None, three_modules=False):
    """A separation twin's YAML as the ``hyperparams.yaml`` of its
    export: the blocks of ``TRAINING_KEYS``, ``modules`` and
    ``lr_scheduler`` taken out, ``modules`` naming the YAML's ``model``
    (or its three parts) as ``SepformerSeparation`` takes them, and a
    ``pretrainer`` that loads each from ``<name>.ckpt``."""
    served = SEPARATOR_MODULES[three_modules]
    kept = _serving_lines(yaml_text, overrides,
                          TRAINING_KEYS + ("modules", "lr_scheduler"))
    kept += ["", "modules:"]
    kept += [f"  {name}: !ref <{ref}>" for name, ref in served.items()]
    kept += _pretrainer_lines(served)
    return "\n".join(kept) + "\n"


def export_classifier(hparams, yaml_text, overrides=None):
    """The best checkpoint (lowest valid ``loss``) of a classification run
    as a ``from_hparams`` source in ``hparams["pretrained_folder"]``: each
    of ``SERVED_MODULES`` as ``<name>.ckpt`` (its part of the checkpoint's
    ``modules.ckpt``), the label encoder's file as ``label_encoder.ckpt``,
    and :func:`served_hparams_text` of the run's YAML as
    ``hyperparams.yaml``. Returns the folder."""
    import torch

    ckpt = hparams["checkpointer"].find_checkpoint(min_key="loss")
    if ckpt is None:
        raise RuntimeError("no checkpoint found to export")
    folder = Path(hparams["pretrained_folder"])
    folder.mkdir(parents=True, exist_ok=True)
    state = torch.load(ckpt.paramfiles["modules"], map_location="cpu",
                       weights_only=True)
    for name in SERVED_MODULES:
        prefix = name + "."
        torch.save({k[len(prefix):]: v for k, v in state.items()
                    if k.startswith(prefix)}, folder / f"{name}.ckpt")
    hparams["label_encoder"].save(folder / "label_encoder.ckpt")
    (folder / "hyperparams.yaml").write_text(
        served_hparams_text(yaml_text, overrides), encoding="utf-8")
    return folder


def export_separator(hparams, yaml_text, overrides=None, folder=None,
                     three_modules=False, min_key="loss"):
    """The best checkpoint (lowest valid ``min_key``) of a separation run
    as a ``SepformerSeparation.from_hparams`` source in ``folder``: the
    model's state as ``masknet.ckpt`` (or its encoder, mask network and
    decoder as ``encoder.ckpt``, ``masknet.ckpt`` and ``decoder.ckpt``
    with ``three_modules``), and :func:`separator_hparams_text` of the
    run's YAML as ``hyperparams.yaml``. Returns the folder."""
    import torch

    ckpt = hparams["checkpointer"].find_checkpoint(min_key=min_key)
    if ckpt is None:
        raise RuntimeError("no checkpoint found to export")
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    state = torch.load(ckpt.paramfiles["modules"], map_location="cpu",
                       weights_only=True)
    for name, ref in SEPARATOR_MODULES[three_modules].items():
        prefix = ref + "."
        torch.save({k[len(prefix):]: v for k, v in state.items()
                    if k.startswith(prefix)}, folder / f"{name}.ckpt")
    (folder / "hyperparams.yaml").write_text(
        separator_hparams_text(yaml_text, overrides, three_modules),
        encoding="utf-8")
    return folder


# the inverse transform of an enhancement YAML's ``compute_stft``, which
# the training YAMLs do not name and ``SpectralMaskEnhancement`` needs
ENHANCER_ISTFT = [
    "compute_istft: !new:speechbrain_tpu_torch.processing.features.ISTFT",
    "  sample_rate: !ref <sample_rate>",
    "  n_fft: !ref <n_fft>",
    "  win_length: !ref <win_length>",
    "  hop_length: !ref <hop_length>",
    "  device: !ref <device>",
]


def enhancer_hparams_text(yaml_text, overrides=None):
    """An enhancement twin's YAML as the ``hyperparams.yaml`` of its
    export: the blocks of ``TRAINING_KEYS`` and ``modules`` taken out,
    ``compute_istft`` added where the YAML has a ``compute_stft`` and no
    inverse, ``modules`` naming the YAML's ``modules.model`` as
    ``enhance_model``, and a ``pretrainer`` that loads it from
    ``enhance_model.ckpt``."""
    model = re.search(r"^modules:\s*\n\s+model:\s*(.+?)\s*$", yaml_text,
                      re.M)
    if model is None:
        raise ValueError("the YAML names no modules.model")
    kept = _serving_lines(yaml_text, overrides, TRAINING_KEYS + ("modules",))
    keys = {m.group(1) for line in kept
            if (m := re.match(r"^(\w+)\s*:", line))}
    if "compute_stft" in keys and "compute_istft" not in keys:
        kept += [""] + ENHANCER_ISTFT
    kept += ["", "modules:", f"  enhance_model: {model.group(1)}"]
    kept += _pretrainer_lines(["enhance_model"])
    return "\n".join(kept) + "\n"


def export_enhancer(hparams, yaml_text, overrides=None, folder=None,
                    yaml_dir=None, min_key="loss"):
    """The best checkpoint (lowest valid ``min_key``) of an enhancement
    run as a ``SpectralMaskEnhancement``/``WaveformEnhancement`` source in
    ``folder``: the model's state as ``enhance_model.ckpt``,
    :func:`enhancer_hparams_text` of the run's YAML as
    ``hyperparams.yaml``, and each file the YAML ``!include:``s, copied
    from ``yaml_dir`` to the same relative path. Returns the folder."""
    import torch

    ckpt = hparams["checkpointer"].find_checkpoint(min_key=min_key)
    if ckpt is None:
        raise RuntimeError("no checkpoint found to export")
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    state = torch.load(ckpt.paramfiles["modules"], map_location="cpu",
                       weights_only=True)
    torch.save({k[len("model."):]: v for k, v in state.items()
                if k.startswith("model.")}, folder / "enhance_model.ckpt")
    for include in re.findall(r"!include:(\S+)", yaml_text):
        dst = folder / include
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(yaml_dir) / include, dst)
    (folder / "hyperparams.yaml").write_text(
        enhancer_hparams_text(yaml_text, overrides), encoding="utf-8")
    return folder


# a frame-level twin's served features and model: the recipe trains
# ``model`` (the CRDNN) and ``out_lin`` as two modules on the unfused
# Fbank; ``VAD`` and ``Speech_Emotion_Diarization`` call one ``model``
FRAME_SERVED = [
    "# kernel B3: the served features (the recipe trains on the unfused "
    "Fbank)",
    "compute_features: !new:speechbrain_tpu_torch.lobes.features.Fbank",
    "  sample_rate: !ref <sample_rate>",
    "  n_mels: !ref <n_mels>",
    "  fused: True",
    "  device: !ref <device>",
    "",
    "# the recipe's two modules in sequence: features -> frame logits",
    "frame_model: !new:speechbrain_tpu_torch.nnet.containers.Sequential",
    "  layers: [!ref <model>, !ref <out_lin>]",
    "",
    "modules:",
    "  model: !ref <frame_model>",
]
# the served model's children, in the order of FRAME_SERVED's layers
FRAME_MODULES = ("model", "out_lin")


def frame_hparams_text(yaml_text, overrides=None):
    """A frame-level twin's YAML as the ``hyperparams.yaml`` of its
    export: the blocks of ``TRAINING_KEYS``, ``modules`` and
    ``compute_features`` taken out, the fused ``Fbank`` and ``modules``
    of ``FRAME_SERVED`` added, and a ``pretrainer`` that loads ``model``
    from ``model.ckpt``."""
    kept = _serving_lines(yaml_text, overrides,
                          TRAINING_KEYS + ("modules", "compute_features"))
    kept += [""] + FRAME_SERVED + _pretrainer_lines(["model"])
    return "\n".join(kept) + "\n"


def export_frame_model(hparams, yaml_text, overrides=None):
    """The best checkpoint (lowest valid ``loss``) of a VAD or emotion
    diarization run as a ``VAD``/``Speech_Emotion_Diarization`` source in
    ``hparams["pretrained_folder"]``: the states of ``FRAME_MODULES`` as
    one ``model.ckpt`` of their sequence, and :func:`frame_hparams_text`
    of the run's YAML as ``hyperparams.yaml``. Returns the folder."""
    import torch

    ckpt = hparams["checkpointer"].find_checkpoint(min_key="loss")
    if ckpt is None:
        raise RuntimeError("no checkpoint found to export")
    folder = Path(hparams["pretrained_folder"])
    folder.mkdir(parents=True, exist_ok=True)
    state = torch.load(ckpt.paramfiles["modules"], map_location="cpu",
                       weights_only=True)
    served = {}
    for i, name in enumerate(FRAME_MODULES):
        prefix = name + "."
        served.update({f"{i}.{k[len(prefix):]}": v for k, v in state.items()
                       if k.startswith(prefix)})
    torch.save(served, folder / "model.ckpt")
    (folder / "hyperparams.yaml").write_text(
        frame_hparams_text(yaml_text, overrides), encoding="utf-8")
    return folder
