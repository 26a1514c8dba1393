"""Pretrained model interfaces (port of
``speechbrain_tpu/inference/interfaces.py``: ``foreign_class``,
``Pretrained`` with ``load_audio`` and ``from_hparams``,
``EncodeDecodePipelineMixin``).

``from_hparams(source)`` fetches ``hyperparams.yaml`` from a local
directory, builds what it names, lets its ``pretrainer`` load each
loadable's file into the objects built, and wraps them in the interface
class. The port's modules hold their own weights, so there is no
``params``/``apply``: the interface calls ``hparams`` and ``mods``
directly. Its modules go to ``run_opts["device"]`` (``"cuda"`` by
default), in ``eval()`` mode with ``requires_grad_(False)``, so that a
caller who forgets ``torch.no_grad()`` still gets an answer and the
kernels' wrappers see no input that requires grad.

A YAML that has a top-level ``device`` key gets the run's device as an
override, so that the objects it builds on a device are built there. The
YAML loader (and so PyYAML) is imported only when a file is parsed; a
machine without PyYAML builds the ``hparams`` dict in Python and calls the
interface class directly.
"""

import importlib.util
import logging
import pathlib
import re
import sys
from types import SimpleNamespace

import torch

from speechbrain_tpu_torch.utils.fetching import fetch

logger = logging.getLogger(__name__)


def _default_savedir(source):
    return f"./pretrained_models/{str(source).replace('/', '--')}"


def foreign_class(source, hparams_file="hyperparams.yaml",
                  pymodule_file="custom.py", classname="CustomInterface",
                  overrides={}, savedir=None, **kwargs):
    """Fetch ``pymodule_file`` from ``source`` beside its hyperparameters,
    import it, and build its ``classname`` by ``from_hparams``: how a model
    ships an interface class of its own."""
    savedir = savedir or _default_savedir(source)
    fetch(hparams_file, source, savedir)
    pymodule_local_path = fetch(pymodule_file, source, savedir)
    sys.path.append(str(pymodule_local_path.parent))
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(pymodule_file).stem, pymodule_local_path
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    cls = getattr(module, classname)
    return cls.from_hparams(source, hparams_file=hparams_file,
                            savedir=savedir, overrides=overrides, **kwargs)


class Pretrained:
    """Base of the pretrained interfaces.

    Arguments
    ---------
    modules : dict, optional
        ``{name: nn.Module}``, reachable as ``self.mods.<name>``.
    hparams : dict, optional
        Reachable as ``self.hparams.<name>``; every ``nn.Module`` in it is
        prepared as ``modules`` are.
    run_opts : dict, optional
        ``"device"``: where the modules run (``"cuda"`` unless asked).

    Subclasses list the hparams and modules they need in
    ``HPARAMS_NEEDED`` and ``MODULES_NEEDED``; a missing one raises
    ``ValueError``.
    """

    HPARAMS_NEEDED = []
    MODULES_NEEDED = []

    def __init__(self, modules=None, hparams=None, run_opts=None):
        run_opts = dict(run_opts or {})
        self.device = torch.device(run_opts.get("device", "cuda"))
        self.mods = torch.nn.ModuleDict(modules or {})
        self.hparams = SimpleNamespace(**(hparams or {}))
        for name in self.HPARAMS_NEEDED:
            if not hasattr(self.hparams, name):
                raise ValueError(f"Need hparams['{name}']")
        for name in self.MODULES_NEEDED:
            if name not in self.mods:
                raise ValueError(f"Need modules['{name}']")
        self._prepare_modules()

    def _prepare_modules(self):
        """Every module, in ``mods`` or in ``hparams``: onto the device,
        evaluation mode, no gradients."""
        modules = list(self.mods.values()) + [
            v for v in vars(self.hparams).values()
            if isinstance(v, torch.nn.Module)
        ]
        for module in modules:
            module.to(self.device)
            module.eval()
            module.requires_grad_(False)

    def load_audio(self, path):
        """One audio file as a 1-D float32 tensor on the device, averaged
        to mono and resampled to ``hparams.sample_rate`` (16000 when the
        hparams name none)."""
        from speechbrain_tpu_torch.dataio.dataio import (
            read_audio,
            read_audio_info,
        )

        signal = torch.from_numpy(read_audio(str(path))).to(self.device)
        _frames, sr, _channels = read_audio_info(path)
        target_sr = getattr(self.hparams, "sample_rate", 16000)
        if sr != target_sr:
            from speechbrain_tpu_torch.augment.time_domain import Resample

            signal = Resample(orig_freq=sr, new_freq=target_sr)(
                signal[None])[0]
        return signal

    @classmethod
    def from_hparams(cls, source, hparams_file="hyperparams.yaml",
                     overrides={}, savedir=None, download_only=False,
                     overrides_must_match=True, run_opts=None, **kwargs):
        """Build the interface from ``source``'s ``hparams_file``: load the
        YAML (with ``overrides``; a top-level ``device`` key gets
        ``run_opts["device"]``), collect the ``pretrainer``'s files into
        ``savedir`` and load them, then ``cls(modules=hparams["modules"],
        hparams=hparams, run_opts=run_opts)``. ``download_only`` collects
        and returns None. Local files are linked into ``savedir``
        (``LocalStrategy.SYMLINK``)."""
        from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

        run_opts = dict(run_opts or {})
        run_opts.setdefault("device", "cuda")
        savedir = savedir or _default_savedir(source)
        hparams_local_path = fetch(hparams_file, source, savedir)
        text = pathlib.Path(hparams_local_path).read_text(encoding="utf-8")
        overrides = dict(overrides)
        if re.search(r"^device\s*:", text, re.M):
            overrides.setdefault("device", str(run_opts["device"]))
        # an !include: of the YAML is read beside its source file
        hparams = load_hyperpyyaml(
            text, overrides, overrides_must_match,
            base_dir=pathlib.Path(hparams_local_path).resolve().parent)
        pretrainer = hparams.get("pretrainer")
        if pretrainer is not None:
            pretrainer.set_collect_in(savedir)
            pretrainer.collect_files(default_source=source)
            if not download_only:
                pretrainer.load_collected()
        if download_only:
            return None
        return cls(modules=hparams.get("modules"), hparams=hparams,
                   run_opts=run_opts, **kwargs)


class EncodeDecodePipelineMixin:
    """Data pipelines of an encode/decode interface, named in hparams:
    ``encode_pipeline`` and ``decode_pipeline`` (``{"steps": ...,
    "output_keys": ...}``) and ``model_output_keys``; the class names
    ``INPUT_STATIC_KEYS`` and ``OUTPUT_KEYS``."""

    def create_pipelines(self):
        from speechbrain_tpu_torch.utils.data_pipeline import DataPipeline

        self.encode_pipeline = DataPipeline(
            static_data_keys=self.INPUT_STATIC_KEYS,
            dynamic_items=self.hparams.encode_pipeline["steps"],
            output_keys=self.hparams.encode_pipeline["output_keys"],
        )
        self.decode_pipeline = DataPipeline(
            static_data_keys=self.hparams.model_output_keys,
            dynamic_items=self.hparams.decode_pipeline["steps"],
            output_keys=self.OUTPUT_KEYS,
        )

    def encode_input(self, input):
        return self.encode_pipeline(input)

    def decode_output(self, output):
        return self.decode_pipeline(output)
