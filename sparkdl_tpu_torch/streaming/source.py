"""Bounded, replayable stream sources (port of
``sparkdl_tpu/streaming/source.py``).

The contract every :class:`StreamSource` owes the runner:

* **Ordered**: chunk ``k`` is always yielded before chunk ``k+1``; offsets
  are dense (0, 1, 2, ...).
* **Content-addressed**: every chunk carries a stable
  :func:`content_chunk_id` derived from its offset and payload bytes, so the
  same chunk re-read after a crash has the same id.  The journal's
  exactly-once guarantee keys on it: duplicate deliveries are suppressed by
  id.  The id is the JAX package's hex for the same payload, so a journal
  written by either package names the same chunks.
* **Replayable**: :meth:`~StreamSource.seek` rewinds to any offset the
  producer still holds; a restarted run seeks to the journal's resume
  offset and re-reads the uncommitted suffix, bit for bit.
* **Bounded**: the producer can mark the stream finished;
  :meth:`~StreamSource.exhausted` turning true (with no chunk pending) ends
  the run.  A live feed that never finishes never ends.

``poll()`` does not block (``None``: nothing available yet); the runner owns
the wait policy (seeded-backoff re-poll and the stall watchdog).  The JAX
package's audited ``named_lock`` is a plain ``threading.Lock`` here, as in
the port's fleet.
"""

from __future__ import annotations

import fnmatch
import os
import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.utils.digest import array_digest, content_chunk_id

__all__ = [
    "content_chunk_id",
    "array_digest",
    "Chunk",
    "StreamSource",
    "MemorySource",
    "DirectorySource",
    "write_directory_chunk",
    "finish_directory_stream",
]


@dataclass(frozen=True)
class Chunk:
    """One unit of stream delivery: a dense ``offset``, the stable
    content-addressed ``chunk_id``, and the host payload (a numpy batch
    shaped like one ``map_batches`` input)."""

    offset: int
    chunk_id: str
    payload: Any


class StreamSource:
    """Interface; see the module docstring for its four contract clauses
    (ordered, content-addressed, replayable, bounded)."""

    def poll(self) -> Optional[Chunk]:
        """The next chunk, or ``None`` when nothing is available yet (the
        runner re-polls with seeded backoff)."""
        raise NotImplementedError

    def exhausted(self) -> bool:
        """True once the stream is finished and every chunk has been
        yielded past the current position: the run's clean end."""
        raise NotImplementedError

    def seek(self, offset: int) -> None:
        """Move so that the next ``poll`` yields ``offset``: crash-resume
        replay positioning."""
        raise NotImplementedError


class MemorySource(StreamSource):
    """In-memory feed: tests and live producers ``feed()`` payloads (thread
    safe) and ``finish()`` to bound the stream.  Chunk ids are computed
    once, at feed time, and survive any number of seeks."""

    def __init__(self, payloads: Sequence[Any] = (), *,
                 finished: bool = False):
        self._lock = threading.Lock()
        self._payloads: List[np.ndarray] = []
        self._ids: List[str] = []
        self._finished = False
        self._next = 0
        for p in payloads:
            self.feed(p)
        if finished:
            self.finish()

    def feed(self, payload: Any) -> str:
        """Append one chunk payload; returns its content-addressed id."""
        arr = np.asarray(payload)
        with self._lock:
            if self._finished:
                raise ValueError("cannot feed a finished MemorySource")
            cid = content_chunk_id(len(self._payloads), arr)
            self._payloads.append(arr)
            self._ids.append(cid)
            return cid

    def finish(self) -> None:
        """Mark the stream bounded: once the remaining chunks drain,
        ``exhausted()`` turns true and the run ends cleanly."""
        with self._lock:
            self._finished = True

    def poll(self) -> Optional[Chunk]:
        with self._lock:
            if self._next >= len(self._payloads):
                return None
            off = self._next
            self._next = off + 1
            return Chunk(off, self._ids[off], self._payloads[off])

    def exhausted(self) -> bool:
        with self._lock:
            return self._finished and self._next >= len(self._payloads)

    def seek(self, offset: int) -> None:
        with self._lock:
            if not 0 <= offset <= len(self._payloads):
                raise ValueError(
                    f"seek offset {offset} outside [0, "
                    f"{len(self._payloads)}]")
            self._next = int(offset)

    def __len__(self) -> int:
        with self._lock:
            return len(self._payloads)


class DirectorySource(StreamSource):
    """Directory-watch source: each ``pattern`` file (default ``*.npy``) is
    one chunk, and lexicographic file order is stream order, so producers
    name monotonically (``chunk-00000042.npy``) and write atomically (tmp
    file + ``os.rename``: a half-written file never matches the pattern).
    The stream is bounded by an ``end_marker`` file (default ``_END``)
    dropped once the last chunk is renamed in.

    Replay is free: the files are still on disk, so ``seek`` moves the
    cursor and re-reads the same bytes under the same ids.  One consumer
    (the runner polls from one thread).
    """

    def __init__(self, path: str, pattern: str = "*.npy",
                 end_marker: str = "_END"):
        self._dir = path
        self._pattern = pattern
        self._end_marker = end_marker
        self._next = 0

    def _listing(self) -> List[str]:
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(n for n in names
                      if fnmatch.fnmatch(n, self._pattern)
                      and n != self._end_marker)

    def poll(self) -> Optional[Chunk]:
        names = self._listing()
        if self._next >= len(names):
            return None
        off = self._next
        payload = np.load(os.path.join(self._dir, names[off]),
                          allow_pickle=False)
        self._next = off + 1
        return Chunk(off, content_chunk_id(off, payload), payload)

    def exhausted(self) -> bool:
        if not os.path.exists(os.path.join(self._dir, self._end_marker)):
            return False
        return self._next >= len(self._listing())

    def seek(self, offset: int) -> None:
        if offset < 0:
            raise ValueError(f"seek offset {offset} negative")
        # past the current listing is legal mid-stream: the journal may
        # hold commits of chunks the producer renames in only later
        self._next = int(offset)


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def write_directory_chunk(path: str, offset: int, payload: Any) -> str:
    """Producer side of :class:`DirectorySource`'s naming and atomicity
    contract: ``np.save`` to a tmp name (which does not match ``*.npy``
    until renamed), fsync, then one atomic ``os.rename`` to
    ``chunk-<offset>.npy``.  Returns the final path."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"chunk-{offset:08d}.npy")
    tmp = final + ".tmp"
    _fsync_write(tmp, lambda f: np.save(f, np.asarray(payload),
                                        allow_pickle=False))
    os.rename(tmp, final)
    return final


def finish_directory_stream(path: str, end_marker: str = "_END") -> None:
    """Drop the end marker: the producer's ``finish()`` for a
    :class:`DirectorySource` (written after the last chunk's rename)."""
    os.makedirs(path, exist_ok=True)
    _fsync_write(os.path.join(path, end_marker), lambda f: None)
