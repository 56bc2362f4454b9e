"""Native host-side audio ops (counterpart of ``f5tts_tpu/audio/native.py``):
the float -> int16 PCM encode and the linear crossfade of two clips, in C++
(``f5tts_tpu_torch/csrc/audioops.cpp``) called through ``ctypes``.

The library is built at first use with the host compiler (``c++ -O3 -shared
-fPIC``, the JAX module's command) into the package's git-ignored
``_build/`` directory beside the kernels, and again whenever the source is
newer. A failed build or load raises with the compiler's output: there is no
numpy fallback (the JAX module falls back to numpy). ``encode_pcm16_plain``
and ``crossfade_pair_plain`` are the numpy forms the tests hold the library
against. Each bound function counts its calls in ``.launches`` (through
``_build.count_launch``, as the kernel wrappers count theirs).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from f5tts_tpu_torch.ops.kernels._build import BUILD_DIR, CSRC_DIR, count_launch

SOURCE = os.path.join(CSRC_DIR, "audioops.cpp")
LIBRARY = os.path.join(BUILD_DIR, "libaudioops.so")
_FLOATS = ctypes.POINTER(ctypes.c_float)
_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run(["c++", "-O3", "-shared", "-fPIC", "-o", tmp, SOURCE], capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"c++ failed for {SOURCE} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent loader never sees a partial file


def load() -> ctypes.CDLL:
    """The library, built first if it is missing or older than its source."""
    global _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(LIBRARY) or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE):
                _build()
            lib = ctypes.CDLL(LIBRARY)
            lib.encode_pcm16.argtypes = [_FLOATS, ctypes.c_int64, ctypes.POINTER(ctypes.c_int16)]
            lib.encode_pcm16.restype = None
            lib.crossfade_pair.argtypes = [_FLOATS, ctypes.c_int64, _FLOATS, ctypes.c_int64, ctypes.c_int64, _FLOATS]
            lib.crossfade_pair.restype = ctypes.c_int64
            _lib = lib
        return _lib


def encode_pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> int16 PCM, clipped and rounded to nearest (even)."""
    lib = load()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out = np.empty(audio.shape, np.int16)
    lib.encode_pcm16(audio.ctypes.data_as(_FLOATS), audio.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    count_launch(encode_pcm16)
    return out


def crossfade_pair(a: np.ndarray, b: np.ndarray, n_fade: int) -> np.ndarray:
    """``[a[:-f]; a[-f:] * fade_out + b[:f] * fade_in; b[f:]]`` with linear
    fades, ``f = min(n_fade, len(a), len(b))``; ``f <= 0`` concatenates."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    n_fade = int(min(n_fade, len(a), len(b)))
    dst = np.empty(len(a) + len(b) - max(n_fade, 0), np.float32)
    n = lib.crossfade_pair(a.ctypes.data_as(_FLOATS), len(a), b.ctypes.data_as(_FLOATS), len(b), n_fade,
                           dst.ctypes.data_as(_FLOATS))
    count_launch(crossfade_pair)
    return dst[:n]


encode_pcm16.launches = 0
crossfade_pair.launches = 0


def encode_pcm16_plain(audio: np.ndarray) -> np.ndarray:
    """The numpy form of ``encode_pcm16`` (the same arithmetic: bit-equal)."""
    return np.rint(np.clip(np.asarray(audio, np.float32), -1.0, 1.0) * np.float32(32767.0)).astype(np.int16)


def crossfade_pair_plain(a: np.ndarray, b: np.ndarray, n_fade: int) -> np.ndarray:
    """The numpy form of ``crossfade_pair``: fades from ``np.linspace``, which
    differ from the library's ``i / (n - 1)`` and ``1 - i / (n - 1)`` by up
    to an ulp at some samples."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    n_fade = int(min(n_fade, len(a), len(b)))
    if n_fade <= 0:
        return np.concatenate([a, b])
    fade_out = np.linspace(1.0, 0.0, n_fade, dtype=np.float32)
    fade_in = np.linspace(0.0, 1.0, n_fade, dtype=np.float32)
    overlap = a[-n_fade:] * fade_out + b[:n_fade] * fade_in
    return np.concatenate([a[:-n_fade], overlap, b[n_fade:]])
