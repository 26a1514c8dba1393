"""Loading pretrained parameters into the objects a YAML built (port of
``speechbrain_tpu/utils/parameter_transfer.py`` ``Pretrainer``).

``Pretrainer`` maps names to loadable objects and each name to a file:
``collect_files`` fetches every file into ``collect_in`` (from its own
path, or ``<name>.ckpt`` from a default source), ``load_collected`` runs
each object's transfer hook on its file (``utils/checkpoints.py``). The
port's modules hold their own weights, so a module is loaded in place.
Not ported: the JAX package's pour of the reference's torch checkpoints
into flax trees (``utils/torch_convert.py``).

Example
-------
>>> import tempfile, torch
>>> src = tempfile.mkdtemp()
>>> torch.save(torch.nn.Linear(2, 2).state_dict(), f"{src}/lin.ckpt")
>>> lin = torch.nn.Linear(2, 2)
>>> pt = Pretrainer(collect_in=tempfile.mkdtemp(), loadables={"lin": lin})
>>> _ = pt.collect_files(default_source=src)
>>> pt.load_collected()
>>> sorted(pt.loaded_paths)
['lin']
"""

import logging
import pathlib

from speechbrain_tpu_torch.utils.checkpoints import (
    DEFAULT_TRANSFER_HOOKS,
    get_default_hook,
)
from speechbrain_tpu_torch.utils.data_utils import split_path
from speechbrain_tpu_torch.utils.fetching import LocalStrategy, fetch

logger = logging.getLogger(__name__)


class Pretrainer:
    """Collect and load pretrained parameters for a set of loadables.

    Arguments
    ---------
    collect_in : str, optional
        Directory the files are collected into (the working directory
        when None).
    loadables : dict, optional
        ``{name: object}``; each object's class (or a base) has a transfer
        hook: ``nn.Module``s, tokenizers, label encoders.
    paths : dict, optional
        ``{name: "source/filename"}``; a name without one is read as
        ``<name>.ckpt`` from ``collect_files``' ``default_source``.
    conditions : dict, optional
        ``{name: bool or callable}``; a name whose condition is false is
        neither collected nor loaded.
    """

    def __init__(self, collect_in=None, loadables=None, paths=None,
                 conditions=None):
        self.collect_in = pathlib.Path(collect_in) if collect_in else None
        self.loadables = {}
        self.paths = {}
        self.conditions = {}
        self.loaded_paths = {}
        self.add_loadables(loadables or {})
        self.add_paths(paths or {})
        self.add_conditions(conditions or {})

    def set_collect_in(self, path):
        self.collect_in = pathlib.Path(path)

    def add_loadables(self, loadables):
        self.loadables.update(loadables)

    def add_paths(self, paths):
        self.paths.update(paths)

    def add_conditions(self, conditions):
        self.conditions.update(conditions)

    @staticmethod
    def split_path(path):
        return split_path(path)

    def is_loadable(self, name):
        if name not in self.conditions:
            return True
        condition = self.conditions[name]
        return bool(condition() if callable(condition) else condition)

    def collect_files(self, default_source=None,
                      local_strategy=LocalStrategy.SYMLINK):
        """Fetch every loadable's file into ``collect_in``; returns and
        keeps ``{name: local path}``."""
        savedir = self.collect_in if self.collect_in else pathlib.Path(".")
        loadable_paths = {}
        for name in self.loadables:
            if not self.is_loadable(name):
                continue
            if name in self.paths:
                source, filename = self.split_path(self.paths[name])
            elif default_source is not None:
                source, filename = default_source, f"{name}.ckpt"
            else:
                raise ValueError(
                    f"Path not specified for '{name}' and no default_source"
                )
            loadable_paths[name] = fetch(
                filename=filename, source=source, savedir=savedir,
                local_strategy=local_strategy,
            )
        self.loaded_paths = loadable_paths
        return loadable_paths

    def load_collected(self):
        """Run each collected loadable's transfer hook on its file; an
        object whose class has no hook raises ``RuntimeError``."""
        for name, obj in self.loadables.items():
            if not self.is_loadable(name) or name not in self.loaded_paths:
                continue
            hook = get_default_hook(obj, DEFAULT_TRANSFER_HOOKS)
            if hook is None:
                raise RuntimeError(
                    f"Don't know how to transfer-load {type(obj)} for "
                    f"'{name}'"
                )
            hook(obj, self.loaded_paths[name])
        logger.info("Loaded pretrained parameters: %s",
                    list(self.loaded_paths))
