"""Exporting a trained model as a ``Pretrained.from_hparams`` source (port
of ``speechbrain_tpu/utils/pretrained.py`` ``save_for_pretrained``)."""

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
