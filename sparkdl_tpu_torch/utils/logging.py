"""Structured logging for the port (``sparkdl_tpu/utils/logging.py``
without the trace-id hook): every subsystem gets a namespaced logger under
``sparkdl_tpu_torch`` with one consistent format."""

from __future__ import annotations

import logging
import os

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_ROOT = "sparkdl_tpu_torch"
_configured = False


def _configure_root():
    global _configured
    if _configured:
        return
    level = os.environ.get("SPARKDL_TPU_LOG_LEVEL", "INFO").upper()
    if level not in ("CRITICAL", "FATAL", "ERROR", "WARNING", "WARN", "INFO",
                     "DEBUG", "NOTSET"):
        logging.getLogger(_ROOT).warning(
            "Invalid SPARKDL_TPU_LOG_LEVEL=%r; using INFO", level)
        level = "INFO"
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    # Callers pass __name__, which already starts with the package prefix.
    if name.startswith(_ROOT):
        name = name[len(_ROOT):].lstrip(".")
    root = logging.getLogger(_ROOT)
    return root.getChild(name) if name else root
