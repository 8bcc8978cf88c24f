"""sparkdl_tpu_torch.streaming: exactly-once continuous scoring (port of
``sparkdl_tpu/streaming``).

A bounded, replayable :class:`StreamSource` yields ordered
content-addressed chunks; :class:`StreamScorer` drives them through an
engine's ``map_batches`` (pipelined by default) or a ``serving.Server``
sink, while a durable fsync'd :class:`Journal` records intent -> output
artifact -> commit per chunk, so that a SIGKILL at any instant (the window
between output write and commit included) restarts into a replay that is
exactly-once and bit-identical to the batch oracle.  A stalled source
degrades :meth:`StreamScorer.health` while seeded-backoff re-polling waits
it out.  The journal's format and the chunk ids are the JAX package's.

Quick use::

    from sparkdl_tpu_torch import streaming

    src = streaming.MemorySource([x0, x1, x2], finished=True)
    scorer = streaming.StreamScorer(
        engine, src, journal_path="j.jsonl", out_dir="out/")
    scorer.run()                       # crash here? run() again: resumes
    y = streaming.assemble_outputs("j.jsonl", "out/")
"""

from sparkdl_tpu_torch.streaming.journal import (COMMIT, INTENT, OUTPUT,
                                                 Journal, JournalFormatError,
                                                 JournalWriteError)
from sparkdl_tpu_torch.streaming.runner import (StreamScorer,
                                                StreamStallError,
                                                assemble_outputs)
from sparkdl_tpu_torch.streaming.source import (Chunk, DirectorySource,
                                                MemorySource, StreamSource,
                                                content_chunk_id,
                                                finish_directory_stream,
                                                write_directory_chunk)

__all__ = [
    "Chunk",
    "StreamSource",
    "MemorySource",
    "DirectorySource",
    "content_chunk_id",
    "write_directory_chunk",
    "finish_directory_stream",
    "Journal",
    "JournalWriteError",
    "JournalFormatError",
    "INTENT",
    "OUTPUT",
    "COMMIT",
    "StreamScorer",
    "StreamStallError",
    "assemble_outputs",
]
