"""Logging setup (reference utils/logging.py:25-285 ``PFBLogger``).

Rich console handler when available, plus per-run plain-text file handlers;
``log_options_dict`` dumps the full run options at start.
"""

from __future__ import annotations

import logging
from datetime import datetime
from pathlib import Path

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"pfb_tpu.{name}")
    if not logging.getLogger("pfb_tpu").handlers:
        root = logging.getLogger("pfb_tpu")
        root.setLevel(logging.INFO)
        try:
            from rich.logging import RichHandler

            handler = RichHandler(show_path=False)
        except Exception:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
    return logger


def add_file_handler(cmd: str, log_directory: str | None) -> str | None:
    """Attach a {log_directory}/{cmd}_{timestamp}.log handler (reference
    behaviour at e.g. core/deconv.py:124-127)."""
    if log_directory is None:
        return None
    Path(log_directory).mkdir(parents=True, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = str(Path(log_directory) / f"{cmd}_{stamp}.log")
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logging.getLogger("pfb_tpu").addHandler(handler)
    return path


def log_options_dict(logger: logging.Logger, opts: dict) -> None:
    logger.info("Options:")
    for k in sorted(opts):
        logger.info("  %s = %s", k, opts[k])
