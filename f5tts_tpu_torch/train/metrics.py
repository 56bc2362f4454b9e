"""Training metrics backends (counterpart of ``f5tts_tpu/train/metrics.py``):
JSONL always works; tensorboard (``torch.utils.tensorboard``) and wandb are
used when they import and never required."""

from __future__ import annotations

import json
import time


class JsonlLogger:
    """Append one JSON object per call to ``path`` (if given) and print it
    (``echo``)."""

    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._f = open(path, "a", buffering=1, encoding="utf-8") if path else None

    def __call__(self, **metrics):
        line = json.dumps({"ts": round(time.time(), 3), **metrics})
        if self._f:
            self._f.write(line + "\n")
        if self.echo:
            print(line, flush=True)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def make_logger(backend: str = "jsonl", run_name: str = "f5tpu", log_dir: str = "runs", resume_id: str | None = None):
    """``'jsonl'`` (``{log_dir}/{run_name}.jsonl``, echoed) | ``'stdout'`` |
    ``'tensorboard'`` (scalars under ``{log_dir}/{run_name}``; ``log.close()``
    closes its writer) | ``'wandb'`` -> ``callable(**metrics)``. A backend that cannot be set up says so and
    logs JSONL instead, as the JAX package does."""
    if backend == "wandb":
        try:
            import wandb  # type: ignore

            run = wandb.init(project=run_name, id=resume_id, resume="allow" if resume_id else None)

            def log(**metrics):
                step = metrics.pop("step", None)
                run.log(metrics, step=step)

            return log
        except Exception:
            print("wandb unavailable; falling back to jsonl")
            return JsonlLogger(f"{log_dir}/{run_name}.jsonl")
    if backend == "tensorboard":
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(log_dir=f"{log_dir}/{run_name}")

            def log(**metrics):
                step = int(metrics.pop("step", 0))
                for k, v in metrics.items():
                    if isinstance(v, (int, float)):
                        writer.add_scalar(k, v, step)
                writer.flush()

            log.close = writer.close
            return log
        except Exception:
            print("tensorboard unavailable; falling back to jsonl")
            return JsonlLogger(f"{log_dir}/{run_name}.jsonl")
    return JsonlLogger(None if backend == "stdout" else f"{log_dir}/{run_name}.jsonl")
