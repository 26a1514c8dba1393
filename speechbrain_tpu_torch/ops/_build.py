"""Builds and loads the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``; nothing
here includes PyTorch's headers, so the build takes seconds. It happens
at first use, from the sources in the package and nothing else, into
``speechbrain_tpu_torch/_build/``. The library's name carries a hash of
the sources, so an edited kernel is rebuilt.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# seconds the last build in this process took (0.0 when the library was
# found already built); ``chip_smoke.py`` reports it
last_build_seconds = 0.0


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        candidate = candidate / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of speechbrain_tpu_torch are "
            "built at first use and need the CUDA toolkit"
        )
    return nvcc


def _run(cmd):
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def build_library():
    """Compile every ``csrc/*.cu`` (one ``nvcc`` per source, all started
    together), link them into one shared library and return its path."""
    global last_build_seconds
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libsbkernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objects, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objects.append(obj)
        procs.append(_run(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
             "-o", str(obj)]
        ))
    logs = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp_lib = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
    link = _run(
        [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objects)]
    )
    out, _ = link.communicate()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the kernels:\n{out}")
    os.replace(tmp_lib, lib_path)
    for obj in objects:
        obj.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    return lib_path


@functools.lru_cache(maxsize=None)
def load_library():
    """The kernels' shared library as a ``ctypes.CDLL`` with the
    argument types of every entry point declared (built on first call)."""
    lib = ctypes.CDLL(str(build_library()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sb_ancestry_attention.argtypes = [
        p, p, p, p, p,          # q, k_cache, v_cache, anc, out
        i, i, i, i, i, i, i,    # B, K, L, H, hd, step, dtype code
        p,                      # stream
    ]
    lib.sb_ancestry_attention.restype = i
    lib.sb_fused_fbank.argtypes = [
        p, p, p, p, p,          # wav, tables, mel ranges, mel weights, out
        i, i, i, i, i, i, i,    # B, T, n_frames, n_fft, n_freq, n_mels, width
        i, i, i, i,             # hop, skew, n_chunks, n_ktiles
        f, f, f,                # amin, multiplier, db_offset
        p,                      # stream
    ]
    lib.sb_fused_fbank.restype = i
    lib.sb_fused_fbank_smem.argtypes = [
        i, i, i, i, i,          # n_fft, n_mels, mel width, hop, skew
        ctypes.POINTER(i),      # stages (out)
        ctypes.POINTER(i),      # frames a block (out)
    ]
    lib.sb_fused_fbank_smem.restype = i
    ll = ctypes.c_longlong
    lib.sb_row_gather.argtypes = [
        p, p, p,                # x, idx, out
        ll, ll, ll,             # n_out, n_src, row_bytes
        i,                      # idx is int64
        p,                      # stream
    ]
    lib.sb_row_gather.restype = i
    lib.sb_flash_attention.argtypes = [
        p, p, p, p, p,          # q, k, v, bias (or None), out
        i, i, i, i, i,          # B, H, Tq, Tk, D
        ctypes.POINTER(ll),     # 15 strides: b, h, t of q, k, v, bias, out
        i, i,                   # dtype code, bias dtype code
        p,                      # stream
    ]
    lib.sb_flash_attention.restype = i
    return lib
