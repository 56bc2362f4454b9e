"""Train-state checkpoints as ``torch.save`` step directories (counterpart
of ``f5tts_tpu/train/checkpoint.py``, which writes orbax state; orbax
checkpoints are not read here).

``<dir>/<step>/state.pt`` holds the whole state (params, optimizer moments,
EMA, step). A save writes a temporary directory and renames it into place,
so a step directory is either complete or absent; the newest ``KEEP`` (3)
steps are kept. ``restore_latest`` falls back to the previous step when the newest
cannot be read (a file torn after the rename, a disk fault)."""

from __future__ import annotations

import logging
import os
import pickle
import re
import shutil
import tempfile

import torch

from f5tts_tpu_torch.train.tree import tree_map

STATE_FILE = "state.pt"
KEEP = 3  # newest steps kept
_log = logging.getLogger("f5tts_tpu_torch.train")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if re.fullmatch(r"\d+", d))


def save_state(directory: str, step: int, state: dict) -> str:
    """Write ``state`` (tensors go to the CPU) as step ``step``; prune to the
    newest ``KEEP`` steps. Returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=directory)
    try:
        torch.save(tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, state),
                   os.path.join(tmp, STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    for old in _steps(directory)[:-KEEP]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
    return final


def restore_state(directory: str, step: int, device="cpu") -> dict:
    return torch.load(os.path.join(directory, str(step), STATE_FILE), map_location=device, weights_only=True)


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_latest(directory: str, device="cpu"):
    """``(step, state)`` of the newest readable step, or ``(None, None)``."""
    for step in reversed(_steps(directory)):
        try:
            return step, restore_state(directory, step, device)
        except (OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
            _log.warning("checkpoint step %d unreadable (%s); falling back", step, e)
    return None, None
