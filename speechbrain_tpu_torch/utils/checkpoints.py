"""Directory-based checkpointing with per-object hooks and retention
(port of ``speechbrain_tpu/utils/checkpoints.py``).

* a checkpoint is a directory ``CKPT+<timestamp>/`` holding one file per
  registered recoverable and a ``CKPT.yaml`` meta file (written as JSON,
  which YAML reads as well, so that no YAML package is needed);
* ``nn.Module``s and ``torch.optim`` optimizers save and load their
  ``state_dict`` with ``torch.save``/``torch.load`` by default hooks;
  a module's tensors load onto the device its parameters lie on;
* any other object takes part through ``@mark_as_saver`` and
  ``@mark_as_loader`` methods on a ``@register_checkpoint_hooks`` class;
* transfer hooks (``@mark_as_transfer``, ``DEFAULT_TRANSFER_HOOKS``) load
  pretrained files for ``utils/parameter_transfer.Pretrainer``; a
  module's refuses a file whose keys or shapes are not its own, before it
  copies anything;
* retention: ``save_and_keep_only`` with ``min_keys``/``max_keys``,
  ``num_to_keep`` and ``ckpt_predicate``.
"""

import collections
import inspect
import json
import logging
import os
import pathlib
import shutil
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)

CKPT_PREFIX = "CKPT"
METAFNAME = f"{CKPT_PREFIX}.yaml"
PARAMFILE_EXT = ".ckpt"

Checkpoint = collections.namedtuple(
    "Checkpoint", ["path", "meta", "paramfiles"]
)
Checkpoint.__doc__ = """A checkpoint found on disk.

path: pathlib.Path of the checkpoint directory;
meta: dict from CKPT.yaml (always has "unixtime" and "end-of-epoch");
paramfiles: {recoverable_name: Path} of each saved object's file.
"""

DEFAULT_SAVE_HOOKS = {}
DEFAULT_LOAD_HOOKS = {}
DEFAULT_TRANSFER_HOOKS = {}


def mark_as_saver(method):
    """Mark ``method(self, path)`` as the saver of its class."""
    try:
        inspect.signature(method).bind(object(), pathlib.Path("testpath"))
    except TypeError:
        raise TypeError("Checkpoint saver must take (self, path)")
    method._speechbrain_saver = True
    return method


def mark_as_loader(method):
    """Mark ``method(self, path, end_of_epoch)`` as the loader of its
    class."""
    try:
        inspect.signature(method).bind(
            object(), pathlib.Path("testpath"), end_of_epoch=True
        )
    except TypeError:
        raise TypeError(
            "Checkpoint loader must take (self, path, end_of_epoch)"
        )
    method._speechbrain_loader = True
    return method


def mark_as_transfer(method):
    """Mark ``method(self, path)`` as the transfer hook of its class: how
    a ``Pretrainer`` loads a pretrained file into an instance."""
    try:
        inspect.signature(method).bind(object(), pathlib.Path("testpath"))
    except TypeError:
        raise TypeError("Transfer hook must take (self, path)")
    method._speechbrain_transfer = True
    return method


def register_checkpoint_hooks(cls):
    """Class decorator: register the class's marked saver, loader and
    transfer hook."""
    for method in cls.__dict__.values():
        if getattr(method, "_speechbrain_saver", False):
            DEFAULT_SAVE_HOOKS[cls] = method
        if getattr(method, "_speechbrain_loader", False):
            DEFAULT_LOAD_HOOKS[cls] = method
        if getattr(method, "_speechbrain_transfer", False):
            DEFAULT_TRANSFER_HOOKS[cls] = method
    return cls


def get_default_hook(obj, default_hooks):
    """The hook of the nearest class in ``obj``'s MRO that has one."""
    for cls in type(obj).__mro__:
        if cls in default_hooks:
            return default_hooks[cls]
    return None


def _module_device(module):
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return torch.device("cpu")


def torch_save(obj, path):
    """Default saver of modules and optimizers: their ``state_dict``."""
    torch.save(obj.state_dict(), path)


def torch_recovery(obj, path, end_of_epoch=False):
    """Default loader of modules and optimizers: ``load_state_dict`` of
    the saved state, a module's onto the device of its parameters (an
    optimizer moves its state to its parameters' device itself)."""
    if isinstance(obj, torch.nn.Module):
        state = torch.load(path, map_location=_module_device(obj),
                           weights_only=True)
        obj.load_state_dict(state, strict=True)
    else:
        obj.load_state_dict(
            torch.load(path, map_location="cpu", weights_only=True)
        )


def torch_transfer(module, path):
    """Default transfer hook of modules: load a saved ``state_dict`` into
    ``module`` onto its device, after checking that the file holds every
    key of the module's state, no other key, and each tensor at its shape
    (the checks of flax's ``from_bytes`` into a target). On a mismatch it
    raises ``RuntimeError`` naming the keys, and the module is left as it
    was: there is no partial load."""
    state = torch.load(path, map_location=_module_device(module),
                       weights_only=True)
    own = module.state_dict()
    missing = sorted(own.keys() - state.keys())
    unexpected = sorted(state.keys() - own.keys())
    shapes = sorted(
        f"{k}: {tuple(state[k].shape)} for {tuple(own[k].shape)}"
        for k in own.keys() & state.keys()
        if tuple(state[k].shape) != tuple(own[k].shape)
    )
    if missing or unexpected or shapes:
        raise RuntimeError(
            f"{path} does not fit {type(module).__name__}: missing keys "
            f"{missing}, unexpected keys {unexpected}, shape mismatches "
            f"{shapes}"
        )
    module.load_state_dict(state, strict=True)


for _cls in (torch.nn.Module, torch.optim.Optimizer):
    DEFAULT_SAVE_HOOKS[_cls] = torch_save
    DEFAULT_LOAD_HOOKS[_cls] = torch_recovery
DEFAULT_TRANSFER_HOOKS[torch.nn.Module] = torch_transfer


def ckpt_recency(ckpt):
    """Recency importance key (the default retention criterion)."""
    return ckpt.meta["unixtime"]


def _plain(obj):
    """Meta values (numpy and 0-d torch scalars) as plain Python."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, torch.Tensor) and obj.ndim == 0:
        return obj.item()
    return obj


def meta_rank(value, higher_is_better):
    """A sort key, best highest, of a checkpoint's meta value: a NaN (a
    stage with no finite loss) ranks below every number, so that no
    ``min_key``/``max_key`` choice keeps or recovers it while a checkpoint
    with a number exists (Python's sort of a bare NaN key is undefined).

    Example
    -------
    >>> sorted([2.0, float("nan"), 1.0],
    ...        key=lambda v: meta_rank(v, False), reverse=True)
    [1.0, 2.0, nan]
    """
    if value != value:
        return (False, 0.0)
    return (True, value if higher_is_better else -value)


class Checkpointer:
    """Saves and recovers registered "recoverables" in checkpoint
    directories.

    Arguments
    ---------
    checkpoints_dir : str | Path
    recoverables : dict, optional
        {name: object} registered at once.

    Example
    -------
    >>> import tempfile
    >>> lin = torch.nn.Linear(2, 2)
    >>> ckpt = Checkpointer(tempfile.mkdtemp(), {"lin": lin})
    >>> _ = ckpt.save_checkpoint(meta={"loss": 1.0})
    >>> ckpt.find_checkpoint(min_key="loss").meta["loss"]
    1.0
    """

    def __init__(self, checkpoints_dir, recoverables=None):
        self.checkpoints_dir = pathlib.Path(checkpoints_dir)
        self.recoverables = {}
        for name, obj in (recoverables or {}).items():
            self.add_recoverable(name, obj)

    def add_recoverable(self, name, obj):
        """Register ``obj`` under ``name``; its class (or a base) must have
        default hooks."""
        if get_default_hook(obj, DEFAULT_SAVE_HOOKS) is None \
                or get_default_hook(obj, DEFAULT_LOAD_HOOKS) is None:
            raise TypeError(
                f"Don't know how to checkpoint {type(obj)}: register hooks "
                "with @register_checkpoint_hooks"
            )
        self.recoverables[name] = obj

    # -- saving ----------------------------------------------------------
    def save_checkpoint(self, meta={}, end_of_epoch=True, verbosity=True):
        """Save a new checkpoint directory; returns its ``Checkpoint``."""
        ckpt_dir = self._new_checkpoint_dirpath()
        os.makedirs(ckpt_dir)
        saved_meta = {"unixtime": time.time(), "end-of-epoch": end_of_epoch}
        saved_meta.update(_plain(meta))
        with open(ckpt_dir / METAFNAME, "w", encoding="utf-8") as fo:
            json.dump(saved_meta, fo)
        paramfiles = {}
        for rname, obj in self.recoverables.items():
            savepath = ckpt_dir / f"{rname}{PARAMFILE_EXT}"
            get_default_hook(obj, DEFAULT_SAVE_HOOKS)(obj, savepath)
            paramfiles[rname] = savepath
        if verbosity:
            logger.info("Saved a checkpoint in %s", ckpt_dir)
        return Checkpoint(ckpt_dir, saved_meta, paramfiles)

    def save_and_keep_only(self, meta={}, end_of_epoch=True,
                           num_to_keep=1, keep_recent=True,
                           importance_keys=[], max_keys=[], min_keys=[],
                           ckpt_predicate=None, verbosity=True):
        """Save, then delete the checkpoints that are in no kept top-k
        set (the newest ``num_to_keep``, and the best ``num_to_keep`` by
        each key)."""
        self.save_checkpoint(meta=meta, end_of_epoch=end_of_epoch,
                             verbosity=verbosity)
        if keep_recent:
            importance_keys = list(importance_keys) + [ckpt_recency]
        self.delete_checkpoints(
            num_to_keep=num_to_keep, importance_keys=importance_keys,
            max_keys=max_keys, min_keys=min_keys,
            ckpt_predicate=ckpt_predicate, verbosity=verbosity,
        )

    def delete_checkpoints(self, *, num_to_keep=1, min_keys=None,
                           max_keys=None, importance_keys=None,
                           ckpt_predicate=None, verbosity=True):
        """Keep the union of the top-k checkpoints by every criterion and
        delete the rest; only those passing ``ckpt_predicate`` are
        considered at all."""
        potential = self.list_checkpoints()
        if ckpt_predicate is not None:
            potential = [c for c in potential if ckpt_predicate(c)]
        keys = list(importance_keys or [])
        if not keys and not max_keys and not min_keys:
            keys = [ckpt_recency]
        protected = set()
        for key in keys:
            ranked = sorted(potential, key=key, reverse=True)
            protected.update(c.path for c in ranked[:num_to_keep])
        for mk, higher_is_better in ([(k, True) for k in max_keys or []]
                                     + [(k, False) for k in min_keys or []]):
            ranked = sorted(
                [c for c in potential if mk in c.meta],
                key=lambda c: meta_rank(c.meta[mk], higher_is_better),
                reverse=True,
            )
            protected.update(c.path for c in ranked[:num_to_keep])
        for ckpt in potential:
            if ckpt.path not in protected:
                self._delete_checkpoint(ckpt, verbosity=verbosity)

    # -- finding ---------------------------------------------------------
    def find_checkpoint(self, importance_key=None, max_key=None,
                        min_key=None, ckpt_predicate=None):
        """The best checkpoint (the newest, or by a meta key), or None."""
        ckpts = self.find_checkpoints(
            importance_key=importance_key, max_key=max_key,
            min_key=min_key, ckpt_predicate=ckpt_predicate,
            max_num_checkpoints=1,
        )
        return ckpts[0] if ckpts else None

    def find_checkpoints(self, importance_key=None, max_key=None,
                         min_key=None, ckpt_predicate=None,
                         max_num_checkpoints=None):
        """Checkpoints sorted best first by the given criterion."""
        if sum(x is not None for x in (importance_key, max_key,
                                       min_key)) > 1:
            raise ValueError(
                "Provide at most one of importance_key/max_key/min_key"
            )
        ckpts = self.list_checkpoints()
        if ckpt_predicate is not None:
            ckpts = [c for c in ckpts if ckpt_predicate(c)]
        if max_key is not None:
            ckpts = [c for c in ckpts if max_key in c.meta]
            importance_key = lambda c: meta_rank(  # noqa: E731
                c.meta[max_key], True)
        elif min_key is not None:
            ckpts = [c for c in ckpts if min_key in c.meta]
            importance_key = lambda c: meta_rank(  # noqa: E731
                c.meta[min_key], False)
        elif importance_key is None:
            importance_key = ckpt_recency
        ckpts = sorted(ckpts, key=importance_key, reverse=True)
        return ckpts[:max_num_checkpoints]

    def list_checkpoints(self):
        """Every checkpoint under ``checkpoints_dir``."""
        if not self.checkpoints_dir.exists():
            return []
        ckpts = []
        for ckpt_dir in self.checkpoints_dir.iterdir():
            if not self._is_checkpoint_dir(ckpt_dir):
                continue
            with open(ckpt_dir / METAFNAME, encoding="utf-8") as fi:
                meta = json.load(fi)
            paramfiles = {
                f.stem: f for f in ckpt_dir.iterdir()
                if f.suffix == PARAMFILE_EXT
            }
            ckpts.append(Checkpoint(ckpt_dir, meta, paramfiles))
        return ckpts

    # -- loading ---------------------------------------------------------
    def recover_if_possible(self, importance_key=None, max_key=None,
                            min_key=None, ckpt_predicate=None):
        """Load the best checkpoint, if there is one; returns it or
        None."""
        chosen = self.find_checkpoint(importance_key, max_key, min_key,
                                      ckpt_predicate)
        if chosen is not None:
            self.load_checkpoint(chosen)
        return chosen

    def load_checkpoint(self, checkpoint):
        """Run every recoverable's load hook on the checkpoint's files."""
        end_of_epoch = checkpoint.meta["end-of-epoch"]
        for name, obj in self.recoverables.items():
            loadpath = checkpoint.paramfiles.get(name)
            if loadpath is None or not loadpath.exists():
                raise RuntimeError(
                    f"Loading checkpoint from {checkpoint.path}, expected "
                    f"{name} to exist in it."
                )
            get_default_hook(obj, DEFAULT_LOAD_HOOKS)(obj, loadpath,
                                                       end_of_epoch)

    # -- internals -------------------------------------------------------
    @staticmethod
    def _is_checkpoint_dir(path):
        path = pathlib.Path(path)
        return (path.is_dir() and path.name.startswith(CKPT_PREFIX)
                and (path / METAFNAME).exists())

    def _new_checkpoint_dirpath(self):
        stamp = time.strftime("%Y-%m-%d+%H-%M-%S", time.localtime())
        n = 0
        while (self.checkpoints_dir / f"{CKPT_PREFIX}+{stamp}+{n:02d}"
               ).exists():
            n += 1
        return self.checkpoints_dir / f"{CKPT_PREFIX}+{stamp}+{n:02d}"

    @staticmethod
    def _delete_checkpoint(checkpoint, verbosity=True):
        if not Checkpointer._is_checkpoint_dir(checkpoint.path):
            raise RuntimeError("Checkpoint does not appear valid for "
                               "deletion.")
        shutil.rmtree(checkpoint.path)
        if verbosity:
            logger.info("Deleted checkpoint in %s", checkpoint.path)


def average_checkpoints(checkpoint_list, recoverable_name):
    """The elementwise mean of one recoverable's state dict over
    ``checkpoint_list`` (the reference's checkpoint averaging for
    evaluation): each floating entry averaged in float64, each other
    entry (integer counters) taken from the first checkpoint. The tensors
    load on the CPU; ``load_state_dict`` casts them to the module's
    dtypes."""
    states = [
        torch.load(c.paramfiles[recoverable_name], map_location="cpu",
                   weights_only=True)
        for c in checkpoint_list
    ]
    first = states[0]
    for state in states[1:]:
        if state.keys() != first.keys():
            raise KeyError(f"{recoverable_name}: the checkpoints hold "
                           f"different entries")
    return {
        key: (sum(s[key].to(torch.float64) for s in states) / len(states)
              if torch.is_floating_point(value) else value)
        for key, value in first.items()
    }
