"""Crash-safe JSONL appending + torn-trailing-line recovery (port of
``sparkdl_tpu/utils/jsonl.py``, the same contract byte for byte).

The write contract: a SIGKILL at ANY instant must leave a valid JSONL file
containing every record written so far.  Each record is a single
``os.write`` of ``line + "\\n"`` (a kill between records can never tear a
line) followed by an ``fsync``.

Failure policy: ``OSError`` (read-only checkout, full disk) DISABLES the
writer instead of failing the run: the artifact is a rider on the real
work.  Check :attr:`CrashSafeJsonlWriter.disabled` (or ``write_line``'s
return) when the record is load-bearing.

The read contract: :func:`read_jsonl` is the one tolerant reader for files
written under this contract.  A power loss or torn flush can leave at most
one partial record at the TAIL, so a final line that fails to parse (or
trailing bytes with no newline) is recoverable damage, while an unparsable
line anywhere EARLIER is real corruption and raises
:class:`JsonlCorruptionError`.  :func:`recover_jsonl` also truncates the
torn tail in place so the file can be re-opened for append.  The flight
recorder (:mod:`sparkdl_tpu_torch.obs.flight`) rides it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple


class CrashSafeJsonlWriter:
    """Append-only fsync'd line writer; see module docstring."""

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = None
        self.disabled = False

    def _open(self, truncate: bool) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        flags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
        if truncate:
            flags |= os.O_TRUNC
        self._fd = os.open(self.path, flags, 0o644)

    def reset(self) -> None:
        """Truncate and start fresh (one run owns one artifact);
        re-enables a writer a previous error disabled."""
        self.close()
        self.disabled = False
        try:
            self._open(truncate=True)
        except OSError:
            self.disabled = True

    def write_line(self, line: str) -> bool:
        """Append one already-serialized JSON line; True iff it reached
        the disk (False once disabled)."""
        if self.disabled:
            return False
        pos = None
        try:
            if self._fd is None:
                self._open(truncate=False)
            pos = os.lseek(self._fd, 0, os.SEEK_END)
            data = (line + "\n").encode()
            while data:  # a short write (disk filling) must not be
                n = os.write(self._fd, data)  # silently reported as done
                data = data[n:]
            os.fsync(self._fd)
            return True
        except OSError:
            # roll back a torn partial record before disabling — the
            # whole point of the writer is that every line on disk
            # parses, including the last one
            if pos is not None:
                try:
                    os.ftruncate(self._fd, pos)
                except OSError:
                    pass
            self.disabled = True
            return False

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None


class JsonlCorruptionError(ValueError):
    """A record that is NOT the trailing line failed to parse — damage
    the crash model cannot explain (a tear only ever eats the tail), so
    the caller must not silently drop committed history."""


def read_jsonl(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Read a crash-safe JSONL file, tolerating a torn tail.

    Returns ``(records, valid_bytes)`` where ``valid_bytes`` is the byte
    offset of the end of the last GOOD record — everything after it (a
    partial trailing record from a crash mid-write, or a final
    newline-terminated line that does not parse) is the torn tail the
    caller may discard.  A missing file reads as ``([], 0)``.  An
    unparsable line that is not the last raises
    :class:`JsonlCorruptionError`.
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], 0
    records: List[Dict[str, Any]] = []
    valid = 0
    pos = 0
    n = len(data)
    while pos < n:
        nl = data.find(b"\n", pos)
        if nl < 0:
            break  # trailing bytes with no newline: torn tail
        line = data[pos:nl].strip()
        if line:
            try:
                records.append(json.loads(line))
            except ValueError:
                if nl + 1 >= n:
                    break  # unparsable FINAL line: torn tail
                raise JsonlCorruptionError(
                    f"{path}: unparsable record at byte {pos} is not the "
                    f"trailing line — corruption, not a torn tail") from None
        pos = nl + 1
        valid = pos
    return records, valid


def recover_jsonl(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """:func:`read_jsonl` + in-place truncation of the torn tail.

    Returns ``(records, discarded_bytes)``.  After this call the file
    ends exactly at the last good record, so re-opening it for append
    (``CrashSafeJsonlWriter``) cannot interleave new records with torn
    bytes.  The truncation is fsync'd — a crash right after recovery
    must not resurrect the tail.
    """
    records, valid = read_jsonl(path)
    discarded = 0
    try:
        size = os.path.getsize(path)
    except OSError:
        return records, 0
    if size > valid:
        discarded = size - valid
        fd = os.open(path, os.O_WRONLY)
        try:
            os.ftruncate(fd, valid)
            os.fsync(fd)
        finally:
            os.close(fd)
    return records, discarded
