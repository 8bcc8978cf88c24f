"""Named counters (the counter half of ``sparkdl_tpu/utils/metrics.py``).

The engine records its pad-to-bucket ledger here (``engine.rows``,
``engine.pad_rows``); a lock keeps concurrent writers exact."""

from __future__ import annotations

import threading
from typing import Dict


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def incr(self, name: str, value: float = 1.0) -> None:
        value = float(value)
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value
