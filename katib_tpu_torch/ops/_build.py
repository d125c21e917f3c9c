"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with its own ``nvcc`` process into a
shared library with a plain C interface; all sources build in parallel. The
libraries land in ``ops/_build/`` (listed in ``.gitignore``) under a name
that carries a hash of the sources and flags, so an edited kernel is rebuilt
and an unchanged one is loaded from the last build. Nothing here runs at
import time: the CPU path never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_fwd_sm90.cu", "flash_bwd_dq_sm90.cu", "flash_bwd_dkv_sm90.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}  # source -> wall seconds of its nvcc run


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> Optional[str]:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}-{_digest(source)}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one nvcc per source,
    all started together; returns source -> library path. The compiler's
    register/shared-memory report goes to ``<library>.log``."""
    with _lock:
        return _build_locked(sources)


def _build_locked(sources: Sequence[str]) -> Dict[str, Path]:
    out = {src: library_path(src) for src in sources}
    todo = [src for src in sources if not out[src].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            f"kernels {todo} cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in todo:
        tmp = out[src].with_name(f"{out[src].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for src, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            continue
        out[src].with_name(out[src].name + ".log").write_text(log)
        os.replace(tmp, out[src])
    if errors:
        raise KernelBuildError("\n".join(errors))
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        path = build([source])[source]
        with _lock:
            lib = _loaded.setdefault(source, ctypes.CDLL(str(path)))
    return lib
