"""Two-sink logging setup (stderr + file), std-logging based.

Counterpart of `matten_tpu/utils/logging.py`.
"""

from __future__ import annotations

import logging
import sys

__all__ = ["set_logger", "get_log_level"]

_LEVEL = "INFO"


def set_logger(level: str = "INFO", filename: str = "matten_tpu.log") -> None:
    """Replace the root logger's handlers with one to stderr and, when
    `filename` is given, one to that file, at `level`."""
    global _LEVEL
    _LEVEL = level.upper()
    root = logging.getLogger()
    root.setLevel(getattr(logging, _LEVEL))
    root.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s"
    )
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if filename:
        fh = logging.FileHandler(filename)
        fh.setFormatter(fmt)
        root.addHandler(fh)


def get_log_level() -> str:
    return _LEVEL
