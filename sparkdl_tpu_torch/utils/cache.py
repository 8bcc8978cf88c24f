"""Thread-safe bounded caches (port of ``sparkdl_tpu/utils/cache.py``).

:class:`BoundedCache` is a FIFO capped by entry count.
:class:`ByteBoundedLRU` is an LRU capped by payload bytes: it backs the
image-file estimator's per-URI decode cache, as in the JAX package, and
the zoo's process-wide engine cache (``transformers/named_image.py``),
where an entry's size is its engine's CUDA-graph pool.  That size is known
only after the engine's first capture, so the LRU can read its entries'
sizes again (:meth:`ByteBoundedLRU.reaccount`), and hands what it evicts to
``on_evict`` (the engine cache releases the evicted engine's graphs there).
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

from sparkdl_tpu_torch.analysis.lockcheck import named_lock


class BoundedCache:
    """FIFO cache capped at ``cap`` entries.  ``get`` is lock-free (a dict
    read); ``put`` and ``clear`` lock, so concurrent workers cannot race
    the eviction loop."""

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._data: Dict[Any, Any] = {}
        self._lock = named_lock("utils.cache.bounded")

    def get(self, key) -> Optional[Any]:
        return self._data.get(key)

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._data:
                # racing double build of the same key: overwrite in place,
                # never evict an unrelated live entry for it
                self._data[key] = value
                return
            while len(self._data) >= self.cap:
                self._data.pop(next(iter(self._data)), None)
            self._data[key] = value

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data


def _default_sizeof(value) -> int:
    # nbytes for array payloads; getsizeof otherwise, so the cap is never
    # silently unenforced for non-array values
    return getattr(value, "nbytes", None) or sys.getsizeof(value)


class ByteBoundedLRU:
    """Thread-safe LRU bounded by total payload BYTES (not entry count).

    Entries report their size through ``sizeof``; an insert evicts
    least-recently-used entries until the total fits ``cap_bytes``.  An
    entry larger than the whole cap is served but never stored.  Each
    entry's size is recorded when it is stored; :meth:`reaccount` reads
    every size again (for entries that grow after they are stored) and
    evicts down to the cap.  ``on_evict(key, value)`` is called for each
    entry evicted by ``put`` or ``reaccount``, outside the lock (not by
    ``clear``)."""

    def __init__(self, cap_bytes: int,
                 sizeof: Optional[Callable[[Any], int]] = None,
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        self.cap_bytes = int(cap_bytes)
        self._sizeof = sizeof or _default_sizeof
        self._on_evict = on_evict
        self._data: Dict[Any, Any] = {}
        self._sizes: Dict[Any, int] = {}
        self._bytes = 0
        self._lock = named_lock("utils.cache.lru")

    def get(self, key, default=None):
        with self._lock:
            if key not in self._data:
                return default
            val = self._data.pop(key)
            self._data[key] = val  # move to most-recent position
            return val

    def _over_cap(self, extra: int = 0, keep=None) -> List[Any]:
        """The least-recently-used keys (never ``keep``) whose removal
        brings the total plus ``extra`` within the cap.  Reads only; the
        caller holds the lock and removes them (:meth:`_pop`)."""
        total, out = self._bytes, []
        for k in self._data:  # insertion order = LRU order
            if total + extra <= self.cap_bytes:
                break
            if k != keep:
                out.append(k)
                total -= self._sizes[k]
        return out

    def _pop(self, keys) -> Tuple[List[Tuple[Any, Any]], int]:
        """Remove ``keys``; returns their (key, value) pairs and the bytes
        they held, which the caller takes off ``_bytes`` under the lock."""
        return ([(k, self._data.pop(k)) for k in keys],
                sum(self._sizes.pop(k) for k in keys))

    def _report(self, evicted: List[Tuple[Any, Any]]) -> None:
        if self._on_evict is not None:
            for k, v in evicted:
                self._on_evict(k, v)

    def put(self, key, value) -> None:
        size = int(self._sizeof(value))
        with self._lock:
            if key in self._data:
                self._bytes -= self._pop([key])[1]
            if size > self.cap_bytes:
                return
            evicted, freed = self._pop(self._over_cap(size))
            self._bytes -= freed
            self._data[key] = value
            self._sizes[key] = size
            self._bytes += size
        self._report(evicted)

    def reaccount(self, keep=None) -> List[Any]:
        """Read every entry's size again, then evict least-recently-used
        entries, never ``keep``, until the total fits the cap.  Returns
        the evicted keys."""
        with self._lock:
            for k, v in self._data.items():
                size = int(self._sizeof(v))
                self._bytes += size - self._sizes[k]
                self._sizes[k] = size
            evicted, freed = self._pop(self._over_cap(keep=keep))
            self._bytes -= freed
        self._report(evicted)
        return [k for k, _ in evicted]

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._sizes.clear()
            self._bytes = 0

    def items(self) -> List[Tuple[Any, Any]]:
        """(key, value) pairs, least recently used first."""
        with self._lock:
            return list(self._data.items())

    @property
    def total_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data
