"""Background-thread prefetch for host pipelines (port of
``sparkdl_tpu/utils/prefetch.py``).

The feed-the-device path is host decode -> host-to-device copy ->
compute.  ``prefetch_iter`` runs the producer (decode) on a background
thread with a bounded queue so host prep of chunk k+1 overlaps device
compute of chunk k.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

_SENTINEL = object()


def prefetch_iter(iterable: Iterable[Any], depth: int = 2) -> Iterator[Any]:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.

    Exceptions in the producer re-raise at the consumer's next pull.  The
    bounded queue caps host memory at O(depth) produced items.
    """
    if depth < 1:
        yield from iterable
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    error: list = []

    def put(item) -> bool:
        # Bounded put that gives up when the consumer abandoned the
        # iterator (e.g. map_batches raised mid-stream) — otherwise the
        # producer would block on the full queue forever, leaking the
        # thread and `depth` decoded chunks per failed transform.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # graftlint: allow=SDL003 reason=re-raised on the consumer side at next pull
            error.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=produce, daemon=True,
                         name="sparkdl-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
