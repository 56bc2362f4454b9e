"""Training metrics: one JSON object per log call (counterpart of
``f5tts_tpu/train/metrics.py:JsonlLogger``)."""

from __future__ import annotations

import json
import time


class JsonlLogger:
    """Append one JSON object per call to ``path`` (if given) and print it."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._f = open(path, "a", buffering=1, encoding="utf-8") if path else None

    def __call__(self, **metrics):
        line = json.dumps({"ts": round(time.time(), 3), **metrics})
        if self._f:
            self._f.write(line + "\n")
        print(line, flush=True)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
