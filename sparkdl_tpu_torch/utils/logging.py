"""Structured logging for the port (port of ``sparkdl_tpu/utils/logging.py``):
every subsystem gets a namespaced logger under ``sparkdl_tpu_torch`` with
one consistent format.

Trace correlation: while span tracing is on (``SPARKDL_TRACE``,
:mod:`sparkdl_tpu_torch.obs.trace`), every record emitted from inside a
span carries that span's trace id (`` trace=t0000af``), so log lines from
the admission thread, the batcher, the dispatch workers and the pipeline
stages join up with the trace artifacts.  With tracing off the hook is one
global read per record and the format is unchanged.
"""

from __future__ import annotations

import logging
import os

# %(name)s is the full dotted logger name (already prefixed);
# %(trace)s is "" or " trace=<id>" (injected by _TraceContextFilter)
_FORMAT = "%(asctime)s %(levelname)s %(name)s%(trace)s: %(message)s"
_ROOT = "sparkdl_tpu_torch"
_configured = False


class _TraceContextFilter(logging.Filter):
    """Stamps each record with the calling thread's current trace id
    (empty when tracing is disabled or no span is open).  Imports the
    tracer lazily, so logging never pulls ``obs`` in at import time."""

    def filter(self, record: logging.LogRecord) -> bool:
        tid = None
        try:
            from sparkdl_tpu_torch.obs.trace import current_trace_id

            tid = current_trace_id()
        except Exception:  # noqa: BLE001  # graftlint: allow=SDL003 reason=logging must never raise
            pass
        record.trace = f" trace={tid}" if tid else ""
        return True


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
    handler.addFilter(_TraceContextFilter())
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
