"""Fetching a model's files from a local source (port of
``speechbrain_tpu/utils/fetching.py``: ``LocalStrategy``, ``FetchFrom``,
``guess_source``, ``link_with_strategy``, ``fetch``).

A local directory is linked or copied into ``savedir`` by the
``LocalStrategy``. A URL or a Hugging Face repository id is recognised and
refused with an error that names it: the port fetches nothing over the
network.

Example
-------
>>> import pathlib, tempfile
>>> src = pathlib.Path(tempfile.mkdtemp())
>>> _ = (src / "model.ckpt").write_text("weights")
>>> path = fetch("model.ckpt", str(src), savedir=tempfile.mkdtemp(),
...              local_strategy=LocalStrategy.COPY)
>>> path.read_text()
'weights'
"""

import enum
import logging
import pathlib
import shutil

logger = logging.getLogger(__name__)


class LocalStrategy(enum.Enum):
    """How a local file reaches ``savedir``: a symbolic link, a copy (with
    or without skipping a cache, the same here), or no link at all (the
    source's own path is returned)."""

    SYMLINK = enum.auto()
    COPY = enum.auto()
    COPY_SKIP_CACHE = enum.auto()
    NO_LINK = enum.auto()


class FetchFrom(enum.Enum):
    """Kinds of source."""

    LOCAL = enum.auto()
    HUGGING_FACE = enum.auto()
    URI = enum.auto()


def guess_source(source):
    """``(FetchFrom, source)`` of a source string, or the tuple as given:
    an ``http(s)://`` URL is a URI, an existing path is local, ``org/repo``
    that is no path is a Hugging Face repository, anything else is taken
    as local."""
    if isinstance(source, tuple):
        return source
    source = str(source)
    if source.startswith(("http://", "https://")):
        return FetchFrom.URI, source
    if pathlib.Path(source).exists():
        return FetchFrom.LOCAL, source
    if source.count("/") == 1 and not source.startswith((".", "/")):
        return FetchFrom.HUGGING_FACE, source
    return FetchFrom.LOCAL, source


def link_with_strategy(src, dst, local_strategy):
    """Put ``src`` at ``dst`` by ``local_strategy``; returns the path to
    use (``src`` itself for ``NO_LINK``)."""
    src = pathlib.Path(src).absolute()
    dst = pathlib.Path(dst).absolute()
    if src == dst:
        return dst
    if local_strategy == LocalStrategy.NO_LINK:
        return src
    dst.parent.mkdir(parents=True, exist_ok=True)
    if dst.exists() or dst.is_symlink():
        dst.unlink()
    if local_strategy == LocalStrategy.SYMLINK:
        dst.symlink_to(src)
    else:
        shutil.copy(src, dst)
    return dst


def fetch(filename, source, savedir="./pretrained_model_checkpoints",
          overwrite=False, local_strategy=LocalStrategy.SYMLINK):
    """The local path of ``filename`` from ``source`` by way of
    ``savedir``: a file already in ``savedir`` is kept unless
    ``overwrite``; a local source's file is linked or copied there. A URL
    or Hugging Face source raises ``ValueError``: this package has no
    network fetch, so the JAX package's network arguments
    (``allow_network``, ``allow_updates``, the cache directories) are not
    taken."""
    savedir = pathlib.Path(savedir)
    savedir.mkdir(parents=True, exist_ok=True)
    destination = savedir / filename
    if destination.exists() and not overwrite:
        return destination
    kind, src = guess_source(source)
    if kind != FetchFrom.LOCAL:
        raise ValueError(
            f"Cannot fetch {filename!r} from {src!r} ({kind.name}): this "
            "package fetches local sources only; copy the files into a "
            "directory and pass its path"
        )
    src_path = pathlib.Path(src) / filename
    if not src_path.exists():
        raise FileNotFoundError(f"{src_path} does not exist")
    return link_with_strategy(src_path, destination, local_strategy)
