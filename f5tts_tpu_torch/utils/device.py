"""Device selection: CUDA unless the caller explicitly asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device; raises when no GPU is
    visible (never a silent CPU fallback). ``"cpu"`` only on request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def to_device(t: torch.Tensor, device: torch.device | str) -> torch.Tensor:
    """A host tensor on ``device`` without a host sync: on CUDA it is copied
    through pinned memory, queued on the current stream behind the work
    already there (a plain ``.to(device)`` from pageable memory waits for
    that work to finish first)."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
