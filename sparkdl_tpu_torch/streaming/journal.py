"""Durable fsync'd JSONL commit journal: the exactly-once core (port of
``sparkdl_tpu/streaming/journal.py``, the same on-disk format field for
field, so each package reads the other's journal, torn tail included).

Three record kinds per chunk, appended strictly in this order through one
:class:`~sparkdl_tpu_torch.utils.jsonl.CrashSafeJsonlWriter` (one ``write``
and one ``fsync`` per record, so a record on disk is a record the kernel
acknowledged)::

    {"rec": "intent", "chunk_id": "...", "offset": N}
    {"rec": "output", "chunk_id": "...", "offset": N,
     "artifact": "out-<id>.npy", "digest": "<sha256>"}
    {"rec": "commit", "chunk_id": "...", "offset": N}

The exactly-once argument, by crash point:

* killed before ``intent``: the chunk was never scored; the replayable
  source yields it again on restart.  No output exists: no loss.
* killed between ``intent`` / ``output`` and ``commit``: an artifact may
  exist, but artifacts are named by the content-addressed chunk id and
  written atomically, so the restart's replay rewrites the same path with
  the same bytes and then commits once.  One id, one artifact, one commit.
* killed mid-append: :func:`~sparkdl_tpu_torch.utils.jsonl.recover_jsonl`
  truncates the torn trailing line at reopen (a tear can only eat the
  tail under the crash-safe write contract), leaving the previous case.
* ``commit`` on disk: the chunk is done; restarts skip it by id
  (:meth:`Journal.is_committed`), and :meth:`Journal.commit` is idempotent
  (a second commit of an id appends nothing).

The journal is the work itself: an append that cannot reach the disk
raises :class:`JournalWriteError` instead of disabling the writer.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.utils.jsonl import CrashSafeJsonlWriter, recover_jsonl

INTENT = "intent"
OUTPUT = "output"
COMMIT = "commit"
_KINDS = (INTENT, OUTPUT, COMMIT)


class JournalWriteError(RuntimeError):
    """A journal append did not reach the disk: the run must stop, since
    progress past this point could neither resume nor be deduplicated."""


class JournalFormatError(ValueError):
    """A fully written journal record has the wrong shape: version drift or
    foreign data, not crash damage."""


class Journal:
    """One journal file is one stream's commit history (append-only;
    restarts replay the log into memory and never rewrite it).

    Construction recovers: the file is read through ``recover_jsonl`` (torn
    tail truncated in place, fsync'd), every record is indexed, and the
    writer reopens in append mode.  ``recovered_torn_bytes`` is how much
    tail a crash tore.
    """

    def __init__(self, path: str):
        self.path = path
        records, self.recovered_torn_bytes = recover_jsonl(path)
        self._lock = named_lock("stream.journal")
        self._intents: Dict[str, int] = {}
        self._outputs: Dict[str, Dict[str, Any]] = {}
        self._committed: Dict[str, int] = {}
        for rec in records:
            self._index(rec)
        self._writer = CrashSafeJsonlWriter(path)

    # -- replay ------------------------------------------------------------
    def _index(self, rec: Dict[str, Any]) -> None:
        kind = rec.get("rec")
        cid = rec.get("chunk_id")
        off = rec.get("offset")
        if kind not in _KINDS or not isinstance(cid, str) \
                or not isinstance(off, int):
            raise JournalFormatError(
                f"{self.path}: bad journal record {rec!r}")
        if kind == INTENT:
            self._intents[cid] = off
        elif kind == OUTPUT:
            self._outputs[cid] = dict(rec)
        else:
            self._committed.setdefault(cid, off)

    # -- append ------------------------------------------------------------
    def _append(self, rec: Dict[str, Any]) -> None:
        if not self._writer.write_line(json.dumps(rec)):
            raise JournalWriteError(
                f"journal append to {self.path} failed (disk full or "
                f"read-only?) — cannot guarantee exactly-once past this "
                f"point")

    def begin(self, chunk_id: str, offset: int) -> None:
        """Intent record: the chunk is about to be scored."""
        with self._lock:
            self._append({"rec": INTENT, "chunk_id": chunk_id,
                          "offset": int(offset)})
            self._intents[chunk_id] = int(offset)

    def record_output(self, chunk_id: str, offset: int, artifact: str,
                      digest: str) -> None:
        """Output record: the artifact is durably on disk (the caller
        wrote, fsync'd and renamed it before this append)."""
        with self._lock:
            rec = {"rec": OUTPUT, "chunk_id": chunk_id,
                   "offset": int(offset), "artifact": artifact,
                   "digest": digest}
            self._append(rec)
            self._outputs[chunk_id] = rec

    def commit(self, chunk_id: str, offset: int) -> bool:
        """Commit record: the chunk is done.  Idempotent: a duplicate
        commit returns False and appends nothing, so the log holds at most
        one commit per id."""
        with self._lock:
            if chunk_id in self._committed:
                return False
            self._append({"rec": COMMIT, "chunk_id": chunk_id,
                          "offset": int(offset)})
            self._committed[chunk_id] = int(offset)
            return True

    # -- queries -----------------------------------------------------------
    def is_committed(self, chunk_id: str) -> bool:
        with self._lock:
            return chunk_id in self._committed

    def seen(self, chunk_id: str) -> bool:
        """An intent or output record exists: a restart scoring this chunk
        is a redelivery (the ``stream.redeliveries`` metric and the
        ``stream.resume`` fault site)."""
        with self._lock:
            return chunk_id in self._intents or chunk_id in self._outputs

    def output_record(self, chunk_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._outputs.get(chunk_id)
            return dict(rec) if rec else None

    def committed_ids(self) -> List[str]:
        """Committed chunk ids in offset order."""
        with self._lock:
            return sorted(self._committed, key=self._committed.get)

    def committed_count(self) -> int:
        with self._lock:
            return len(self._committed)

    def committed_offsets(self) -> List[int]:
        """Sorted committed offsets: the assembler's density check (dense
        0..n-1: no gap, no duplicate)."""
        with self._lock:
            return sorted(self._committed.values())

    def resume_offset(self) -> int:
        """The first offset not covered by the contiguous committed prefix:
        where a restarted, in-order run seeks its source.  Committed chunks
        past it (out-of-order history) are suppressed by id at delivery."""
        with self._lock:
            done = set(self._committed.values())
            n = 0
            while n in done:
                n += 1
            return n

    def uncommitted(self) -> List[Dict[str, Any]]:
        """Chunks with an intent or output record and no commit: the
        replay set a restart owes the stream."""
        with self._lock:
            return [{"chunk_id": cid, "offset": off,
                     "has_output": cid in self._outputs}
                    for cid, off in sorted(self._intents.items(),
                                           key=lambda kv: kv[1])
                    if cid not in self._committed]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "path": self.path,
                "intents": len(self._intents),
                "outputs": len(self._outputs),
                "committed": len(self._committed),
                "recovered_torn_bytes": self.recovered_torn_bytes,
            }

    def close(self) -> None:
        self._writer.close()
