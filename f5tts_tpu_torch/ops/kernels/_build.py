"""Build and load the hand-written CUDA kernels (``f5tts_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, under the package's git-ignored ``_build/`` directory, at
first use (and again whenever the source is newer than the library). The
library is loaded with ``ctypes``; wrappers pass raw device pointers and
PyTorch's current stream. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: dict[str, str] = {}  # kernel name -> nvcc/ptxas output of its last build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not os.path.exists(lib):
        return True
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in [source_path(name), *headers])


def _start_build(name: str) -> tuple[subprocess.Popen, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library_path(name)}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def _finish_build(name: str, proc: subprocess.Popen, tmp: str) -> None:
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source_path(name)} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, library_path(name))  # atomic: concurrent loaders never see a partial file


def build(names: list[str]) -> None:
    """Compile every stale source in ``names``, one ``nvcc`` per source, all
    started together."""
    with _lock:
        started = [(n, *_start_build(n)) for n in names if _stale(n)]
        errors = []
        for name, proc, tmp in started:
            try:
                _finish_build(name, proc, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
