"""Logging setup (counterpart of ``f5tts_tpu/utils/logging.py``): stdout and a
rotating file (10 MB x 5), the level from ``F5TPU_LOG_LEVEL`` unless given."""

from __future__ import annotations

import logging
import logging.config
import os


def setup_logging(log_file: str | None = "f5tpu.log", level: str | None = None) -> logging.Logger:
    level = level or os.environ.get("F5TPU_LOG_LEVEL", "INFO").upper()
    handlers = {
        "console": {"class": "logging.StreamHandler", "formatter": "std", "stream": "ext://sys.stdout"},
    }
    if log_file:
        handlers["file"] = {
            "class": "logging.handlers.RotatingFileHandler",
            "formatter": "std",
            "filename": log_file,
            "maxBytes": 10 * 1024 * 1024,
            "backupCount": 5,
        }
    logging.config.dictConfig(
        {
            "version": 1,
            "disable_existing_loggers": False,
            "formatters": {"std": {"format": "%(asctime)s %(name)s %(levelname)s %(message)s"}},
            "handlers": handlers,
            "root": {"level": level, "handlers": list(handlers)},
        }
    )
    return logging.getLogger("f5tpu")
