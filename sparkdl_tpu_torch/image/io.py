"""Host-side image decode / resize / file ingestion (port of
``sparkdl_tpu/image/io.py``).

Decode runs on the host; the output of this layer is either image-struct
rows (for the DataFrame API) or dense uint8 numpy batches (for the device
pipeline).  pyarrow and PIL are imported here and in the rest of the data
layer only.  ``decodeResizeBatch`` and ``structsToBatch`` route to the
native core (``sparkdl_tpu_torch/native``: libjpeg/libpng decode and
bilinear resize in C++ threads, without the GIL) wherever it builds, as the
JAX package's do, and to PIL elsewhere; ``arrowStructsToBatch`` resizes
with PIL, as JAX's does.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import pyarrow as pa

from sparkdl_tpu_torch.image.schema import (
    imageArrayToStruct,
    imageSchema,
    imageStructToArray,
    imageTypeByMode,
)


def PIL_decode(raw_bytes: bytes) -> Optional[np.ndarray]:
    """Decode compressed image bytes to a [H,W,3] uint8 **BGR** array.

    Counterpart of ``imageIO.PIL_decode``/``_decodeImage``: undecodable input
    yields ``None`` (the reference drops/nulls such rows rather than failing
    the job).
    """
    import io as _io

    from PIL import Image

    try:
        img = Image.open(_io.BytesIO(raw_bytes))
        img = img.convert("RGB")
        rgb = np.asarray(img, dtype=np.uint8)
    # PIL raises many exception types for bad bytes; None rides the
    # ok-mask drop-to-null contract
    except Exception:
        return None
    return np.ascontiguousarray(rgb[:, :, ::-1])  # RGB -> BGR (OpenCV order)


def decodeImage(raw_bytes: bytes, origin: str = "") -> Optional[dict]:
    """Decode bytes into an image struct dict, or None on failure."""
    arr = PIL_decode(raw_bytes)
    if arr is None:
        return None
    return imageArrayToStruct(arr, origin=origin)


def resizeImage(array: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a [H,W,C] uint8/float32 array on the host.

    Counterpart of the Scala ``ImageUtils.resizeImage`` (java.awt bilinear) and
    the TF resize the Python path used — parity is tolerance-based, matching
    the reference's own tests (they assert closeness, not bit-equality, across
    their two resize backends).
    """
    from PIL import Image

    if array.shape[0] == height and array.shape[1] == width:
        return array
    dtype = array.dtype
    if dtype == np.uint8:
        img = Image.fromarray(array if array.shape[2] != 1 else array[:, :, 0])
        out = np.asarray(img.resize((width, height), Image.BILINEAR), dtype=np.uint8)
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    # float path: resize channel-planes via PIL 'F' mode
    planes = [
        np.asarray(
            Image.fromarray(array[:, :, c].astype(np.float32), mode="F")
            .resize((width, height), Image.BILINEAR))
        for c in range(array.shape[2])
    ]
    return np.stack(planes, axis=2).astype(dtype)


def createResizeImageUDF(size: Sequence[int]) -> Callable[[dict], dict]:
    """Return a row-level function image-struct -> resized image-struct
    (``imageIO.createResizeImageUDF``); apply it with
    ``DataFrame.map_rows``."""
    if len(size) != 2:
        raise ValueError(f"New image size should have format [height, width], got {size}")
    height, width = int(size[0]), int(size[1])

    def _resize(row: Optional[dict]) -> Optional[dict]:
        if row is None:
            return None
        arr = imageStructToArray(row)
        out = resizeImage(arr, height, width)
        return imageArrayToStruct(out, origin=row.get("origin", ""))

    return _resize


def structToModelInput(struct: dict, height: int, width: int) -> np.ndarray:
    """Image struct -> [h,w,3] uint8 **RGB** array resized for a model:
    grayscale replicates to 3 channels, BGRA drops alpha, BGR flips to RGB
    (the reference's converter subgraph)."""
    arr = imageStructToArray(struct)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    c = arr.shape[2]
    if c == 1:
        arr = np.repeat(arr, 3, axis=2)
    elif c == 4:
        arr = arr[:, :, :3]          # BGRA -> BGR
    arr = resizeImage(arr, height, width)
    return arr[:, :, ::-1]           # BGR -> RGB


def _native_io_preferred() -> bool:
    """Use the native core whenever it built (the JAX package's rule)."""
    from sparkdl_tpu_torch import native

    return native.native_available()


def decodeResizeBatch(blobs: Sequence[bytes], height: int, width: int
                      ) -> "tuple[np.ndarray, np.ndarray]":
    """Decode + resize encoded images into a [N,h,w,3] uint8 **RGB** batch
    and an ok-mask: the native core where it built, else PIL threaded on
    the shared IO pool.  Undecodable rows: ok=False, zeroed pixels
    (drop-to-null upstream).

    Fault site ``io.decode`` (per row): an injected decode error rides the
    same drop-to-null contract as a corrupt blob; a plan with
    ``io.decode`` rules routes around the native core and decodes in row
    order on this thread, so ``at=`` / ``every=`` schedules name the row
    they drop."""
    from sparkdl_tpu_torch import faults as _faults

    io_faults = _faults.has_rules("io.decode")
    if not io_faults and _native_io_preferred():
        from sparkdl_tpu_torch import native

        result = native.decode_resize_batch(blobs, height, width)
        if result is not None:
            return result
    out = np.zeros((len(blobs), height, width, 3), dtype=np.uint8)
    ok = np.zeros(len(blobs), dtype=bool)

    def one(i_blob):
        i, blob = i_blob
        try:
            _faults.inject("io.decode", row=i)
        except _faults.InjectedFault:
            return  # simulated corrupt row: ok stays False (drop-to-null)
        arr = PIL_decode(blob)  # BGR or None
        if arr is None:
            return
        if arr.shape[2] == 1:
            arr = np.repeat(arr, 3, axis=2)
        out[i] = resizeImage(arr, height, width)[:, :, ::-1]
        ok[i] = True

    if len(blobs) >= 4 and not io_faults:
        list(_io_executor().map(one, enumerate(blobs)))
    else:
        for pair in enumerate(blobs):
            one(pair)
    return out, ok


def filesToModelBatch(paths: Sequence[str], height: int, width: int
                      ) -> "tuple[np.ndarray, np.ndarray]":
    """Read + decode + resize files into a model-ready uint8 RGB batch and
    an ok-mask (an unreadable file is a failed row)."""
    blobs = []
    for p in paths:
        try:
            with open(p, "rb") as fh:
                blobs.append(fh.read())
        except OSError:
            blobs.append(b"")
    return decodeResizeBatch(blobs, height, width)


def structsToBatch(structs: Sequence[dict], height: int, width: int,
                   num_threads: Optional[int] = None) -> np.ndarray:
    """Decode + resize image structs into one [N,h,w,3] uint8 RGB batch:
    the native core's resize for four or more structs where it built, else
    PIL threaded on the shared IO pool (PIL releases the GIL in resize)."""
    if len(structs) == 0:
        return np.zeros((0, height, width, 3), dtype=np.uint8)
    if _native_io_preferred() and len(structs) >= 4:
        from sparkdl_tpu_torch import native

        def to_rgb(s):
            arr = imageStructToArray(s)
            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            c = arr.shape[2]
            if c == 1:
                arr = np.repeat(arr, 3, axis=2)
            elif c == 4:
                arr = arr[:, :, :3]
            return np.ascontiguousarray(arr[:, :, ::-1])  # BGR -> RGB

        batch = native.resize_batch_rgb(
            [to_rgb(s) for s in structs], height, width)
        if batch is not None:
            return batch
    if (num_threads is not None and num_threads <= 1) or len(structs) < 4:
        arrs = [structToModelInput(s, height, width) for s in structs]
    else:
        arrs = list(_io_executor().map(
            lambda s: structToModelInput(s, height, width), structs))
    return np.stack(arrs, axis=0)


_IO_EXECUTOR = None


def _io_executor():
    """Shared host-prep thread pool — reused across batches (spawning a pool
    per device batch would put thread startup on the feed-the-device path)."""
    global _IO_EXECUTOR
    if _IO_EXECUTOR is None:
        from concurrent.futures import ThreadPoolExecutor

        _IO_EXECUTOR = ThreadPoolExecutor(
            min(16, (os.cpu_count() or 4)), thread_name_prefix="sparkdl-torch-io")
    return _IO_EXECUTOR


def arrowStructsToBatch(column, height: int, width: int,
                        channel_order: str = "rgb", compact: bool = False
                        ) -> "tuple[np.ndarray, np.ndarray]":
    """Image-struct Arrow column -> ([N,h,w,3] uint8 batch, valid mask)
    WITHOUT materializing per-row Python dicts.

    Zero-copy on the scoring hot path: child arrays are
    read as numpy views over Arrow buffers, and each row's pixel block is
    sliced straight out of the binary child's value buffer.  When every
    valid row is already ``height x width`` uint8 BGR (the common case for a
    resized column), packing is one ~memcpy per row.  Chunked columns are
    packed chunk by chunk (never ``combine_chunks``, whose int32 binary
    offsets overflow past 2 GB of image bytes).

    ``channel_order``: "rgb" (default) swaps BGR struct bytes to RGB on the
    host; "bgr" returns the struct's native byte order untouched — the fast
    feed for pipelines that fold the channel swap into the device program
    (as the reference's converter subgraph did: ``graph/pieces.py``
    buildSpImageConverter swapped BGR->RGB *inside* the graph); the swap
    is the only non-memcpy work.

    ``compact``: when True the batch holds ONLY the ok rows (in row order) —
    row ``k`` of the batch is the ``k``-th True of the mask — so callers
    feeding an engine skip both the null-row zero fill and a second
    valid-rows copy.  When False (default) the batch is row-aligned with
    the column and failed rows are zeroed, matching the reference's
    scoring-path null contract.
    """
    if channel_order not in ("rgb", "bgr"):
        raise ValueError(f"channel_order must be 'rgb' or 'bgr', "
                         f"got {channel_order!r}")
    if isinstance(column, pa.ChunkedArray):
        chunks = column.chunks
        if len(chunks) == 1:
            column = chunks[0]
        else:
            parts = [arrowStructsToBatch(c, height, width,
                                         channel_order=channel_order,
                                         compact=compact)
                     for c in chunks if len(c)]
            if not parts:
                return (np.zeros((0, height, width, 3), dtype=np.uint8),
                        np.zeros(0, dtype=bool))
            return (np.concatenate([p[0] for p in parts], axis=0),
                    np.concatenate([p[1] for p in parts], axis=0))
    n = len(column)
    ok = np.zeros(n, dtype=bool)
    if n == 0:
        return np.zeros((0, height, width, 3), dtype=np.uint8), ok
    valid = np.asarray(column.is_valid())
    idx = np.nonzero(valid)[0]
    nrows = len(idx) if compact else n
    if len(idx) == 0:
        return np.zeros((nrows, height, width, 3), dtype=np.uint8), ok
    # Child arrays: pyarrow's .field() applies the parent struct's
    # offset/length, so sliced columns are handled.
    heights = np.asarray(column.field("height"))
    widths = np.asarray(column.field("width"))
    channels = np.asarray(column.field("nChannels"))
    modes = np.asarray(column.field("mode"))
    data = column.field("data")
    # Binary child buffers: [validity, int32 offsets, values].  The child
    # carries its own offset when the parent was sliced.
    bufs = data.buffers()
    offsets = np.frombuffer(bufs[1], dtype=np.int32)[
        data.offset:data.offset + n + 1]
    values = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None \
        else np.zeros(0, dtype=np.uint8)

    # slot[k]: output row for source row idx[k]
    slots = np.arange(len(idx)) if compact else idx
    uniform = (
        np.all(heights[idx] == height) and np.all(widths[idx] == width)
        and np.all(channels[idx] == 3) and np.all(modes[idx] == 16)  # CV_8UC3
        and np.all((offsets[idx + 1] - offsets[idx]) == height * width * 3))
    if uniform:
        hw3 = height * width * 3
        # compact output is fully written -> skip the zero fill
        alloc = np.empty if compact else np.zeros
        if channel_order == "bgr":
            out = alloc((nrows, height, width, 3), dtype=np.uint8)
            for s, i in zip(slots, idx):  # pure memcpy per row
                out[s] = values[offsets[i]:offsets[i] + hw3].reshape(
                    height, width, 3)
        else:
            # memcpy rows, then one batch-level channel shuffle (3 strided
            # assigns beat a negative-stride copy ~3x on this host)
            # non-compact alloc is zeros, so null rows stay zeroed through
            # the shuffle; compact output has no null slots to zero
            tmp = alloc((nrows, height, width, 3), dtype=np.uint8)
            for s, i in zip(slots, idx):
                tmp[s] = values[offsets[i]:offsets[i] + hw3].reshape(
                    height, width, 3)
            out = np.empty_like(tmp)
            out[..., 0] = tmp[..., 2]
            out[..., 1] = tmp[..., 1]
            out[..., 2] = tmp[..., 0]
        ok[idx] = True
        return out, ok

    # General path: per-row buffer views (still no dict round trip), then
    # the normal channel normalization + resize, threaded for large rows.
    out = np.zeros((nrows, height, width, 3), dtype=np.uint8)

    def one(si):
        s, i = si
        t = imageTypeByMode(int(modes[i]))
        h, w, c = int(heights[i]), int(widths[i]), int(channels[i])
        row = values[offsets[i]:offsets[i + 1]]
        arr = row.view(t.dtype) if t.dtype != "uint8" else row
        if arr.size != h * w * c:
            return
        arr = arr.reshape(h, w, c)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        if c == 1:
            arr = np.repeat(arr, 3, axis=2)
        elif c == 4:
            arr = arr[:, :, :3]
        resized = resizeImage(np.ascontiguousarray(arr), height, width)
        out[s] = resized if channel_order == "bgr" else resized[:, :, ::-1]
        ok[i] = True

    pairs = list(zip(slots, idx))
    if len(pairs) >= 4:
        list(_io_executor().map(one, pairs))
    else:
        for p in pairs:
            one(p)
    if compact and not ok[idx].all():
        # a valid struct failed decode (size mismatch): drop its slot so
        # batch rows stay aligned with the True positions of the mask
        out = out[ok[idx]]
    return out, ok


def _list_files(path: str, recursive: bool = False) -> List[str]:
    """Expand a path/glob/directory into a sorted file list (deterministic
    ordering replaces Spark's nondeterministic partition enumeration)."""
    if os.path.isdir(path):
        pattern = os.path.join(path, "**" if recursive else "*")
        files = [f for f in _glob.glob(pattern, recursive=recursive)
                 if os.path.isfile(f)]
    else:
        files = [f for f in _glob.glob(path, recursive=recursive)
                 if os.path.isfile(f)]
    return sorted(files)


def iterFileBatches(path: str, batch_size: int = 64,
                    recursive: bool = False) -> Iterable[pa.RecordBatch]:
    """LAZILY read files under ``path`` into ``{filePath, fileData}`` record
    batches of ``batch_size`` rows — bytes for one batch at a time, never
    the whole directory (the streaming analog of the reference's
    ``sc.binaryFiles`` partition iterator).  Compose with any transformer's
    ``transformStream``."""
    files = _list_files(path, recursive=recursive)
    batch_size = max(1, int(batch_size))
    for off in range(0, len(files), batch_size):
        chunk = files[off:off + batch_size]
        data = []
        for f in chunk:
            with open(f, "rb") as fh:
                data.append(fh.read())
        yield pa.record_batch({
            "filePath": pa.array(chunk, type=pa.string()),
            "fileData": pa.array(data, type=pa.binary()),
        })


def iterImageBatches(path: str, batch_size: int = 64, recursive: bool = False,
                     decode_f: Callable[[bytes], Optional[np.ndarray]] = None
                     ) -> Iterable[pa.RecordBatch]:
    """LAZILY decode images under ``path`` into image-struct record batches
    (null structs for undecodable files).  Peak host memory is one batch of
    decoded images, not the dataset."""
    decode = decode_f if decode_f is not None else PIL_decode
    for rb in iterFileBatches(path, batch_size=batch_size,
                              recursive=recursive):
        files = rb.column(0).to_pylist()
        blobs = rb.column(1).to_pylist()
        structs = []
        for f, blob in zip(files, blobs):
            arr = decode(blob)
            if arr is None:
                structs.append(None)
            elif isinstance(arr, dict):
                structs.append(arr)
            else:
                structs.append(
                    imageArrayToStruct(np.asarray(arr), origin=f))
        yield pa.record_batch({"image": pa.array(structs, type=imageSchema)})


def filesToDF(path: str, numPartitions: Optional[int] = None,
              recursive: bool = False):
    """Read raw files into a DataFrame ``{filePath: str, fileData:
    binary}`` (``imageIO.filesToDF``); for datasets larger than host RAM,
    use :func:`iterFileBatches` and ``transformStream``."""
    from sparkdl_tpu_torch.frame import DataFrame

    table = pa.Table.from_batches(
        list(iterFileBatches(path, batch_size=1 << 30, recursive=recursive)),
        schema=pa.schema([pa.field("filePath", pa.string()),
                          pa.field("fileData", pa.binary())]))
    df = DataFrame(table)
    if numPartitions:
        df = df.repartition(numPartitions)
    return df


def readImagesWithCustomFn(path: str, decode_f: Callable[[bytes], Optional[np.ndarray]],
                           numPartitions: Optional[int] = None,
                           recursive: bool = False):
    """Read images under ``path`` using a custom decoder into an image-struct
    DataFrame.  Counterpart of ``imageIO.readImagesWithCustomFn``; rows whose
    decode fails become null image structs (kept, so origins stay auditable).
    For datasets that don't fit in host RAM, use :func:`iterImageBatches` +
    ``transformStream`` instead of materializing a frame."""
    from sparkdl_tpu_torch.frame import DataFrame

    schema = pa.schema([pa.field("image", imageSchema)])
    table = pa.Table.from_batches(
        list(iterImageBatches(path, batch_size=256, recursive=recursive,
                              decode_f=decode_f)),
        schema=schema)
    df = DataFrame(table)
    if numPartitions:
        df = df.repartition(numPartitions)
    return df


def readImages(path: str, numPartitions: Optional[int] = None,
               recursive: bool = False):
    """Read images with the default PIL decoder (BGR uint8)."""
    return readImagesWithCustomFn(path, PIL_decode, numPartitions, recursive)
