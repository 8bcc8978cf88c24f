"""TensorFlow's V2 checkpoint (tensor bundle) reader, without TensorFlow.

A checkpoint prefix ``P`` names ``P.index`` and ``P.data-NNNNN-of-MMMMM``
shards.  The index is a LevelDB table (``tensorflow/core/lib/io/table``):

* a 48-byte footer: the metaindex and index block handles (two varint64
  pairs, zero-padded to 40 bytes) and the magic ``0xdb4775248b80fb57``;
* blocks of prefix-compressed ``(key, value)`` entries with restart points,
  each followed by a 5-byte trailer: the compression type (0 = none, 1 =
  snappy) and the block's masked crc32c;
* the index block maps each data block's last key to its handle.

The ``""`` key holds a ``BundleHeaderProto``; every other key is a tensor
name whose value is a ``BundleEntryProto`` (dtype, shape, shard, offset,
size, masked crc32c of the bytes).  TensorFlow writes the index blocks
uncompressed; a snappy-compressed block raises (there is no snappy here).
Each tensor's crc32c is checked on read, as TensorFlow checks it on restore.

:func:`crc32c` is table-driven (slicing by 4) and vectorised over 1 KiB
lanes with numpy, the lanes' registers then combined pairwise with GF(2)
shift operators; ``tools/crc32c_timing.py`` times it over a full-size
InceptionV3's 96 MB against a byte-at-a-time Python loop.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.graph import proto as _proto

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48
BLOCK_TRAILER_SIZE = 5
_NO_COMPRESSION, _SNAPPY = 0, 1
_MASK_DELTA = 0xA282EAD8


class CheckpointError(ValueError):
    """A checkpoint that is missing, malformed or fails its checksum."""


# -- crc32c (Castagnoli, reflected polynomial 0x82F63B78) ----------------

_POLY = 0x82F63B78


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1)
    return t.astype(np.uint32)


_TABLE = _byte_table()
_TABLE_LIST = _TABLE.tolist()


def _slice4_tables() -> np.ndarray:
    """Slicing-by-4: ``t[k][b]`` is byte ``b``'s register after ``k``
    further zero bytes."""
    t = [_TABLE]
    for _ in range(3):
        t.append((t[-1] >> 8) ^ _TABLE[t[-1] & 0xFF])
    return np.stack(t)


_T4 = _slice4_tables()
_CHUNK = 1024           # bytes per vectorised lane
_VECTOR_MIN = 1 << 16   # below this a plain loop is quicker


def _crc_loop(reg: int, data) -> int:
    """Run the CRC register over ``data`` one byte at a time (no pre or
    post conditioning)."""
    t = _TABLE_LIST
    for b in data:
        reg = t[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _zeros_operator(nbytes: int) -> List[int]:
    """The register's linear map for ``nbytes`` zero bytes, as the images
    of its 32 basis bits."""
    return [_crc_loop(1 << k, bytes(nbytes)) for k in range(32)]


def _operator_tables(cols: List[int]) -> np.ndarray:
    """Four 256-entry tables applying a linear map byte by byte."""
    tabs = np.zeros((4, 256), dtype=np.uint32)
    v = np.arange(256, dtype=np.uint32)
    for byte in range(4):
        acc = np.zeros(256, dtype=np.uint32)
        for bit in range(8):
            acc ^= np.where((v >> bit) & 1, np.uint32(cols[8 * byte + bit]),
                            np.uint32(0))
        tabs[byte] = acc
    return tabs


def _apply(tabs: np.ndarray, reg: np.ndarray) -> np.ndarray:
    return (tabs[0][reg & 0xFF] ^ tabs[1][(reg >> 8) & 0xFF]
            ^ tabs[2][(reg >> 16) & 0xFF] ^ tabs[3][reg >> 24])


def _compose(a: List[int], b: List[int]) -> List[int]:
    """The map ``a`` after ``b``."""
    out = []
    for col in b:
        acc, k = 0, 0
        while col:
            if col & 1:
                acc ^= a[k]
            col >>= 1
            k += 1
        out.append(acc)
    return out


_SHIFT_TABLES: Dict[int, np.ndarray] = {}


def _shift_tables(level: int) -> np.ndarray:
    """Tables of the map for ``_CHUNK * 2**level`` zero bytes."""
    if level not in _SHIFT_TABLES:
        cols = _zeros_operator(_CHUNK)
        for _ in range(level):
            cols = _compose(cols, cols)
        _SHIFT_TABLES[level] = _operator_tables(cols)
    return _SHIFT_TABLES[level]


def _crc_vector(data: np.ndarray) -> int:
    """The register after ``data`` (a multiple of ``_CHUNK`` bytes) from
    zero: every chunk's register in parallel lanes, then a pairwise
    tree of ``shift(left) ^ right``."""
    lanes = data.view("<u4").reshape(-1, _CHUNK // 4)
    k = lanes.shape[0]
    width = 1 << (k - 1).bit_length()
    words = np.zeros((_CHUNK // 4, width), dtype=np.uint32)
    # leading zero chunks leave a zero register unchanged
    words[:, width - k:] = lanes.T
    t0, t1, t2, t3 = _T4
    reg = np.zeros(width, dtype=np.uint32)
    for w in words:   # four bytes a step
        reg ^= w
        reg = (t3[reg & 0xFF] ^ t2[(reg >> 8) & 0xFF]
               ^ t1[(reg >> 16) & 0xFF] ^ t0[reg >> 24])
    level = 0
    while reg.shape[0] > 1:
        reg = _apply(_shift_tables(level), reg[0::2]) ^ reg[1::2]
        level += 1
    return int(reg[0])


def crc32c(data) -> int:
    """CRC-32C of ``data`` (bytes-like)."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = buf.shape[0]
    if n < 4:
        return _crc_loop(0xFFFFFFFF, buf.tobytes()) ^ 0xFFFFFFFF
    # an all-ones initial register equals a zero register with the first
    # four bytes inverted
    head = bytes(b ^ 0xFF for b in buf[:4].tobytes())
    if n < _VECTOR_MIN:
        return _crc_loop(_crc_loop(0, head), buf[4:].tobytes()) ^ 0xFFFFFFFF
    buf = np.concatenate([np.frombuffer(head, np.uint8), buf[4:]])
    whole = (n // _CHUNK) * _CHUNK
    reg = _crc_vector(buf[:whole])
    reg = _crc_loop(reg, buf[whole:].tobytes())
    return reg ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# -- the LevelDB table ---------------------------------------------------


def _handle(buf, pos: int) -> Tuple[int, int, int]:
    off, pos = _proto._varint(buf, pos)
    size, pos = _proto._varint(buf, pos)
    return off, size, pos


def _block(data: bytes, off: int, size: int, path: str) -> memoryview:
    end = off + size + BLOCK_TRAILER_SIZE
    if end > len(data):
        raise CheckpointError(f"{path}: block at {off} runs past the end")
    kind = data[off + size]
    masked = int.from_bytes(data[off + size + 1:end], "little")
    if unmask_crc(masked) != crc32c(memoryview(data)[off:off + size + 1]):
        raise CheckpointError(f"{path}: block at {off} fails its crc32c")
    if kind == _SNAPPY:
        raise CheckpointError(
            f"{path}: block at {off} is snappy-compressed; this reader has "
            f"no snappy (TensorFlow writes checkpoint indexes uncompressed)")
    if kind != _NO_COMPRESSION:
        raise CheckpointError(f"{path}: unknown block compression {kind}")
    return memoryview(data)[off:off + size]


def _entries(block: memoryview) -> Iterator[Tuple[bytes, memoryview]]:
    """A block's ``(key, value)`` entries, keys rebuilt from their shared
    prefixes (a restart point stores its whole key, shared = 0)."""
    n = len(block)
    if n < 4:
        raise CheckpointError("block shorter than its restart count")
    num_restarts = int.from_bytes(block[n - 4:], "little")
    limit = n - 4 - 4 * num_restarts
    if limit < 0:
        raise CheckpointError("block restart array runs past its start")
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _proto._varint(block, pos)
        non_shared, pos = _proto._varint(block, pos)
        vlen, pos = _proto._varint(block, pos)
        if shared > len(key) or pos + non_shared + vlen > limit:
            raise CheckpointError("corrupt block entry")
        key = key[:shared] + bytes(block[pos:pos + non_shared])
        pos += non_shared
        yield key, block[pos:pos + vlen]
        pos += vlen


def read_table(path: str) -> Dict[bytes, bytes]:
    """Every ``(key, value)`` of a LevelDB table file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_SIZE:
        raise CheckpointError(f"{path}: shorter than a table footer")
    footer = memoryview(data)[len(data) - FOOTER_SIZE:]
    magic = int.from_bytes(footer[40:], "little")
    if magic != TABLE_MAGIC:
        raise CheckpointError(f"{path}: bad table magic {magic:#x}")
    _, _, pos = _handle(footer, 0)               # metaindex: unused
    index_off, index_size, _ = _handle(footer, pos)
    out: Dict[bytes, bytes] = {}
    for _, handle in _entries(_block(data, index_off, index_size, path)):
        off, size, _ = _handle(handle, 0)
        for k, v in _entries(_block(data, off, size, path)):
            out[k] = bytes(v)
    return out


# -- the bundle ----------------------------------------------------------


class BundleReader:
    """The tensors of a V2 checkpoint prefix, read on demand by name."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index = prefix + ".index"
        if not os.path.exists(index):
            raise CheckpointError(f"no checkpoint index {index!r}")
        table = read_table(index)
        if b"" not in table:
            raise CheckpointError(f"{index}: no bundle header")
        self.header = _proto.BundleHeaderProto.parse(table.pop(b""))
        if self.header.endianness != 0:
            raise CheckpointError(f"{index}: big-endian bundles are not read")
        self.entries: Dict[str, _proto.BundleEntryProto] = {
            k.decode("utf-8"): _proto.BundleEntryProto.parse(v)
            for k, v in table.items()}
        self._shards: Dict[int, bytes] = {}

    def keys(self) -> List[str]:
        return sorted(self.entries)

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def _shard(self, i: int) -> bytes:
        if i not in self._shards:
            path = (f"{self.prefix}.data-{i:05d}-of-"
                    f"{max(self.header.num_shards, 1):05d}")
            with open(path, "rb") as f:
                self._shards[i] = f.read()
        return self._shards[i]

    def tensor(self, name: str) -> np.ndarray:
        """The tensor stored under ``name`` (bfloat16 as its uint16 bit
        patterns), its crc32c checked."""
        if name not in self.entries:
            raise KeyError(f"{name!r} is not in checkpoint {self.prefix!r}")
        e = self.entries[name]
        if e.slices:
            raise CheckpointError(f"{name}: partitioned variables are not read")
        dtype = _proto.numpy_dtype(e.dtype, f"checkpoint tensor {name!r}")
        if e.dtype == _proto.DT_STRING:
            raise CheckpointError(f"{name}: string tensors are not read")
        data = self._shard(e.shard_id)
        if e.offset + e.size > len(data):
            raise CheckpointError(f"{name}: bytes past the end of its shard")
        raw = memoryview(data)[e.offset:e.offset + e.size]
        if unmask_crc(e.crc32c) != crc32c(raw):
            raise CheckpointError(f"{name}: data fails its crc32c")
        return np.frombuffer(raw, dtype=dtype).copy().reshape(
            e.shape.as_list())


def _unescape(s: str) -> str:
    """A text-format string literal's C escapes."""
    return s.encode("latin-1").decode("unicode_escape").encode(
        "latin-1").decode("utf-8")


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The prefix named by ``model_checkpoint_path`` in the directory's
    ``checkpoint`` state file (text format), resolved against the
    directory when relative; None when there is none or its index is
    missing (as ``tf.train.latest_checkpoint``)."""
    state = os.path.join(checkpoint_dir, "checkpoint")
    if not os.path.exists(state):
        return None
    with open(state, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r'^\s*model_checkpoint_path\s*:\s*"((?:[^"\\]|\\.)*)"',
                  text, re.M)
    if m is None:
        return None
    path = _unescape(m.group(1))
    if not os.path.isabs(path):
        path = os.path.join(checkpoint_dir, path)
    return path if os.path.exists(path + ".index") else None
