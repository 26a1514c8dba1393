"""Builds the port's host C++ sources (the WAV decoder, the edit-distance
core) with ``g++`` at first use.

Each source is compiled from the package's own copy into
``speechbrain_tpu_torch/_build/``, never next to the source. The shared
object's name carries a hash of the source and the flags, so an edited
source is rebuilt. The build runs under a lock (a thread lock and a file
lock, so that concurrent processes build once), and the object is written
under a temporary name and renamed into place. A failed build or load
raises ``RuntimeError`` carrying the compiler's output; nothing falls back
to other code.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()


def build_host_library(source):
    """Compile ``source`` (a ``.cpp`` path) into a shared object under
    ``_build/`` unless one for the same source and flags exists; returns
    its path."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    lib_path = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{source.stem}.lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if lib_path.exists():  # another process built it meanwhile
                return lib_path
            tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run(
                    ["g++", *CXX_FLAGS, "-o", str(tmp), str(source)],
                    capture_output=True, text=True,
                )
            except OSError as e:
                raise RuntimeError(
                    f"cannot run g++ to build {source.name}: {e}"
                ) from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed to build {source.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, lib_path)
    return lib_path


def load_host_library(source):
    """``ctypes.CDLL`` of ``source`` built by :func:`build_host_library`;
    raises ``RuntimeError`` where it does not load."""
    path = build_host_library(source)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
