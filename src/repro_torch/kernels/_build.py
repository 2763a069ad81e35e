"""Build the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a library with a plain
C interface, loaded with ``ctypes``. The build happens at first use, into
``build/`` at the repository root, and is reused while its source and the
flags hash the same. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "filter", "dequant", "bitunpack",
           "page_unpack")                         # csrc/<name>.cu


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    build_s: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register and spill report)


_loaded: dict[str, Built] = {}
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(src: Path) -> str:
    """Hash of the flags and the one source built: a change to another
    kernel's source does not rebuild this one."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    Thread-safe: the read path launches kernels from a thread pool."""
    if name in _loaded:
        return _loaded[name]
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            _loaded[name] = _make(name)
    return _loaded[name]


def load_all(names=SOURCES) -> dict[str, Built]:
    """``load`` for several sources (default: every kernel of the port), one
    ``nvcc`` each, all started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as ex:
        return dict(zip(names, ex.map(load, names)))


def _make(name: str) -> Built:
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
    log_path = so.with_suffix(".log")
    t0 = time.perf_counter()
    built_now = not so.exists()
    if built_now:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return Built(lib=ctypes.CDLL(str(so)), path=so,
                 build_s=time.perf_counter() - t0 if built_now else 0.0,
                 log=log_path.read_text() if log_path.exists() else "")
