"""Audio-quality metrics for certifying sampler and distillation settings
(counterpart of ``f5tts_tpu/eval/quality.py``; a copy, host-side numpy).

A reduced-compute configuration (fewer steps, guidance caching, a distilled
student) is measured by its deviation from a reference solve of the same
weights, noise and prompts, on log-mel frames (the model's output space, and
what the vocoder consumes):

- ``mel_l2``: RMSE over the selected (generated) frames; conditioning frames
  are pasted back verbatim by the sampler, so a frame mask leaves them out.
- ``log_mel_mae``: mean absolute log-mel error, in log-magnitude units.
- ``mcd``: mel-cepstral distortion (dB): DCT-II cepstra, coefficients 1..K
  (c0, the energy, excluded), the standard 10/ln10 * sqrt(2 sum dc^2) form.
- ``spectral_convergence``: ||A - B||_F / ||B||_F on linear-mel magnitudes.
"""

from __future__ import annotations

import numpy as np

_MCD_CONST = 10.0 / np.log(10.0) * np.sqrt(2.0)


def _valid(a: np.ndarray, b: np.ndarray, frame_mask: np.ndarray | None):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if frame_mask is None:
        frame_mask = np.ones(a.shape[:-1], bool)
    return a[frame_mask], b[frame_mask]


def mel_l2(a: np.ndarray, b: np.ndarray, frame_mask: np.ndarray | None = None) -> float:
    """RMSE over selected (generated) frames of log-mel ``(..., n, d)``."""
    av, bv = _valid(a, b, frame_mask)
    return float(np.sqrt(np.mean((av - bv) ** 2)))


def log_mel_mae(a: np.ndarray, b: np.ndarray, frame_mask: np.ndarray | None = None) -> float:
    av, bv = _valid(a, b, frame_mask)
    return float(np.mean(np.abs(av - bv)))


def _dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II basis ``(n_in, n_out)`` (mel bins -> cepstra)."""
    k = np.arange(n_out)[None, :]
    i = np.arange(n_in)[:, None]
    basis = np.cos(np.pi * (i + 0.5) * k / n_in) * np.sqrt(2.0 / n_in)
    basis[:, 0] *= np.sqrt(0.5)
    return basis


def mcd(a: np.ndarray, b: np.ndarray, frame_mask: np.ndarray | None = None, n_cep: int = 13) -> float:
    """Mel-cepstral distortion in dB over selected frames (c1..c{n_cep})."""
    av, bv = _valid(a, b, frame_mask)  # (frames, d) log-mel
    basis = _dct_matrix(av.shape[-1], n_cep + 1)
    ca = av @ basis
    cb = bv @ basis
    d = ca[:, 1:] - cb[:, 1:]  # drop c0 (energy)
    return float(np.mean(_MCD_CONST * np.sqrt(np.sum(d * d, axis=-1))))


def spectral_convergence(a: np.ndarray, b: np.ndarray, frame_mask: np.ndarray | None = None) -> float:
    """‖A − B‖_F / ‖B‖_F on linear-mel magnitudes (b = the recipe output)."""
    av, bv = _valid(a, b, frame_mask)
    av = np.exp(av)
    bv = np.exp(bv)
    return float(np.linalg.norm(av - bv) / max(np.linalg.norm(bv), 1e-12))


def quality_report(candidate: np.ndarray, recipe: np.ndarray,
                   frame_mask: np.ndarray | None = None) -> dict[str, float]:
    return {
        "mel_l2": mel_l2(candidate, recipe, frame_mask),
        "log_mel_mae": log_mel_mae(candidate, recipe, frame_mask),
        "mcd_db": mcd(candidate, recipe, frame_mask),
        "spectral_convergence": spectral_convergence(candidate, recipe, frame_mask),
    }
