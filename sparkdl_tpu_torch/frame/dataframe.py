"""A minimal columnar DataFrame over pyarrow (port of
``sparkdl_tpu/frame/dataframe.py``).

Design notes:
  * Chunking is explicit: a frame is a ``pyarrow.Table`` whose record batches
    play the role Spark partitions played in the reference — transformers
    process the frame batch-wise and the inference engine re-buckets rows into
    fixed device batch shapes (padding the tail).
  * No lazy plan/optimizer: the reference's laziness came from Spark; here
    stages run eagerly over Arrow batches, which keeps host->device pipelining
    in our control (see sparkdl_tpu_torch.parallel.engine).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import pyarrow as pa


class Row(dict):
    """Dict-like row with attribute access (quacks like pyspark.sql.Row)."""

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError:
            raise AttributeError(item)


class _StructView(dict):
    """Zero-copy row view of an Arrow struct column handed to ``map_rows``
    fns.  Behaves as the plain dict the row path produced, except binary
    children are ``memoryview`` slices over the Arrow value buffer (wrap
    with ``bytes()`` when a real bytes object is required — numpy/PIL/io
    consumers take memoryview directly).  Identity is tracked so a fn that
    returns the view unchanged lets the column be re-emitted without any
    Python->Arrow round trip; any in-place MUTATION marks the view dirty
    so the passthrough is defeated and the mutation is preserved (the old
    to_pylist path's behavior)."""

    __slots__ = ("_src", "_idx", "_dirty")

    def _touch(self):
        self._dirty = True

    def __setitem__(self, k, v):
        self._touch()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._touch()
        super().__delitem__(k)

    def update(self, *a, **kw):
        self._touch()
        super().update(*a, **kw)

    def pop(self, *a):
        self._touch()
        return super().pop(*a)

    def popitem(self):
        self._touch()
        return super().popitem()

    def clear(self):
        self._touch()
        super().clear()

    def setdefault(self, k, default=None):
        if k not in self:
            self._touch()
        return super().setdefault(k, default)

    def __ior__(self, other):
        # dict.__ior__ bypasses the Python-level update override
        self._touch()
        return super().__ior__(other)


def _struct_view_rows(arr: "pa.StructArray"):
    """Per-row dict views of a flat struct column, read from Arrow buffers.

    The to_pylist row path copies the MB-scale binary child into fresh
    bytes per row; buffer views copy nothing.  Returns None when a child type is outside
    this fast path (nested lists/structs, ...) — caller falls back to
    to_pylist.
    """
    n = len(arr)
    cols = []
    for i in range(arr.type.num_fields):
        f = arr.type.field(i)
        child = arr.field(i)
        t = f.type
        if pa.types.is_binary(t) or pa.types.is_large_binary(t):
            if child.null_count:  # per-CHILD fallback: the other children
                cols.append((f.name, "py", child.to_pylist()))  # stay fast
                continue
            bufs = child.buffers()
            odt = np.int64 if pa.types.is_large_binary(t) else np.int32
            offs = np.frombuffer(bufs[1], odt)[
                child.offset:child.offset + n + 1]
            data_mv = memoryview(bufs[2]) if bufs[2] is not None else \
                memoryview(b"")
            cols.append((f.name, "bin", (offs, data_mv)))
        elif child.null_count == 0 and (
                pa.types.is_integer(t) or pa.types.is_floating(t)):
            np_child = child.to_numpy(zero_copy_only=False)
            cols.append((f.name, "num", np_child))
        elif (pa.types.is_string(t) or pa.types.is_large_string(t)
              or pa.types.is_boolean(t) or pa.types.is_integer(t)
              or pa.types.is_floating(t) or pa.types.is_null(t)):
            cols.append((f.name, "py", child.to_pylist()))
        else:
            return None
    valid = np.asarray(arr.is_valid()) if arr.null_count else None
    rows = []
    for i in range(n):
        if valid is not None and not valid[i]:
            rows.append(None)
            continue
        view = _StructView()
        for name, kind, c in cols:
            if kind == "num":
                view[name] = c[i].item()
            elif kind == "bin":
                offs, mv = c
                view[name] = mv[offs[i]:offs[i + 1]]
            else:
                view[name] = c[i]
        view._src = arr
        view._idx = i
        view._dirty = False  # population above set it; arm tracking now
        rows.append(view)
    return rows


def _passthrough_source(vals):
    """The untouched source StructArray iff every mapped value is the
    row-aligned ``_StructView`` of one source column (None only where the
    source row itself is null); else None and the caller materializes."""
    src = None
    for i, v in enumerate(vals):
        if isinstance(v, _StructView):
            if (v._dirty or v._idx != i
                    or (src is not None and v._src is not src)):
                return None
            src = v._src
        elif v is not None:
            return None
    if src is None or len(src) != len(vals):
        return None
    if src.null_count:
        valid = np.asarray(src.is_valid())
        for i, v in enumerate(vals):
            if v is None and valid[i]:
                return None  # fn nulled a live row: must materialize
    elif any(v is None for v in vals):
        return None
    return src


def _promote_schema(schema: Optional[pa.Schema],
                    t: pa.Table) -> pa.Schema:
    """Widen the running ``schema`` with ``t``'s (null -> concrete,
    int -> float, ...) — the shared promotion rule of the batch-wise
    mappers.  Inferring each batch independently and unifying is what
    keeps a later float batch from being silently TRUNCATED against an
    int-pinned first batch (``from_pylist(schema=...)`` coerces 3.5 -> 3
    without raising)."""
    if schema is None:
        return t.schema
    if t.schema != schema:
        return pa.unify_schemas([schema, t.schema],
                                promote_options="permissive")
    return schema


def _concat_conforming(tables: List[pa.Table], schema: pa.Schema) -> pa.Table:
    """Concat per-batch tables under the unified ``schema``: a batch may
    lack a column some other batch produced — null-fill it (the pinned-
    schema behavior) before the ordered cast."""
    def conform(t: pa.Table) -> pa.Table:
        for field in schema:
            if field.name not in t.column_names:
                t = t.append_column(field.name,
                                    pa.nulls(len(t), field.type))
        return t.select([f.name for f in schema]).cast(schema)

    return pa.concat_tables([conform(t) for t in tables])


def _to_table(data) -> pa.Table:
    if isinstance(data, pa.Table):
        return data
    if isinstance(data, pa.RecordBatch):
        return pa.Table.from_batches([data])
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            return pa.Table.from_pandas(data, preserve_index=False)
    except ImportError:
        pass
    if isinstance(data, dict):
        return pa.table(data)
    if isinstance(data, list):  # list of dict rows
        return pa.Table.from_pylist(data)
    raise TypeError(f"Cannot build DataFrame from {type(data).__name__}")


class DataFrame:
    """Immutable columnar frame backed by a ``pyarrow.Table``."""

    def __init__(self, data):
        self._table = _to_table(data)

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_pandas(pdf) -> "DataFrame":
        return DataFrame(pa.Table.from_pandas(pdf, preserve_index=False))

    @staticmethod
    def from_rows(rows: List[dict], schema: Optional[pa.Schema] = None) -> "DataFrame":
        if schema is not None:
            return DataFrame(pa.Table.from_pylist(rows, schema=schema))
        return DataFrame(pa.Table.from_pylist(rows))

    # -- introspection -----------------------------------------------------
    @property
    def table(self) -> pa.Table:
        return self._table

    @property
    def schema(self) -> pa.Schema:
        return self._table.schema

    @property
    def columns(self) -> List[str]:
        return self._table.column_names

    def count(self) -> int:
        return self._table.num_rows

    def __len__(self) -> int:
        return self._table.num_rows

    def __repr__(self):
        return f"DataFrame[{', '.join(f'{f.name}: {f.type}' for f in self.schema)}] ({len(self)} rows)"

    # -- relational ops ----------------------------------------------------
    def select(self, *cols: str) -> "DataFrame":
        return DataFrame(self._table.select(list(cols)))

    def drop(self, *cols: str) -> "DataFrame":
        keep = [c for c in self.columns if c not in cols]
        return DataFrame(self._table.select(keep))

    def withColumn(self, name: str, values) -> "DataFrame":
        """Append/replace a column.  ``values`` may be a pyarrow Array /
        ChunkedArray, numpy array (any rank: rank 2 becomes a
        ``list<leaf dtype>`` column, rank>=3 nests ``fixed_size_list``
        per trailing dim, leaf dtype preserved), or Python list."""
        if isinstance(values, (pa.Array, pa.ChunkedArray)):
            arr = values
        elif isinstance(values, np.ndarray):
            if values.ndim == 1:
                arr = pa.array(values)
            elif values.ndim == 2:
                # list-of-leaf-dtype column (rows stay 1-D arrays, so
                # pyarrow keeps the numpy leaf dtype)
                arr = pa.array(list(values))
            else:
                # rank>=3: pa.array refuses >1-D elements — build nested
                # fixed_size_list layers over the flattened values buffer
                # (leaf dtype preserved, no per-row Python round trip)
                arr = pa.array(np.ascontiguousarray(values).reshape(-1))
                for dim in reversed(values.shape[1:]):
                    arr = pa.FixedSizeListArray.from_arrays(arr, int(dim))
        else:
            arr = pa.array(values)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        t = self._table
        if name in t.column_names:
            # Replace in place, preserving schema position (pyspark semantics).
            idx = t.column_names.index(name)
            return DataFrame(t.set_column(idx, name, arr))
        return DataFrame(t.append_column(name, arr))

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        names = [new if c == old else c for c in self.columns]
        return DataFrame(self._table.rename_columns(names))

    def filter(self, mask) -> "DataFrame":
        """Filter by boolean mask (numpy array / list / pyarrow bool array)."""
        if isinstance(mask, (list, np.ndarray)):
            mask = pa.array(np.asarray(mask, dtype=bool))
        return DataFrame(self._table.filter(mask))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._table.slice(0, n))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(pa.concat_tables([self._table, other._table],
                                          promote_options="default"))

    def repartition(self, n: int) -> "DataFrame":
        """Re-chunk into ``n`` roughly equal record batches.  Partition-count
        variation is the reference's stand-in for multi-node behavior in tests
        (SURVEY.md §4) — preserved here for the same purpose."""
        n = max(1, min(int(n), max(1, len(self))))
        rows = len(self)
        sizes = [rows // n + (1 if i < rows % n else 0) for i in range(n)]
        combined = self._table.combine_chunks()
        batches, off = [], 0
        for s in sizes:
            if s == 0:
                continue
            batches.append(combined.slice(off, s))
            off += s
        return DataFrame(pa.concat_tables(batches) if batches else combined)

    @property
    def num_partitions(self) -> int:
        col0 = self._table.column(0) if self._table.num_columns else None
        return col0.num_chunks if col0 is not None else 1

    # -- materialization ---------------------------------------------------
    def collect(self) -> List[Row]:
        return [Row(r) for r in self._table.to_pylist()]

    def to_pandas(self):
        return self._table.to_pandas()

    def toPandas(self):
        return self.to_pandas()

    def dropna(self, *cols: str) -> "DataFrame":
        """Drop rows that are null in any of ``cols`` (all columns if none
        given).  Nulls arise by design — e.g. undecodable images become null
        structs (see image.io.readImagesWithCustomFn)."""
        import pyarrow.compute as pc

        names = list(cols) if cols else self.columns
        mask = None
        for c in names:
            valid = pc.is_valid(self._table.column(c))
            mask = valid if mask is None else pc.and_(mask, valid)
        return DataFrame(self._table.filter(mask)) if mask is not None else self

    def column_to_numpy(self, name: str) -> np.ndarray:
        """Materialize a column as numpy; list<float> columns stack to 2-D.

        Uniform-length list columns are read from the Arrow values buffer
        directly (one reshape — no per-row Python list round trip).
        Ragged columns fall back to the row path
        and raise the same stacking error numpy would.
        """
        col = self._table.column(name)
        if col.null_count:
            raise ValueError(
                f"Column {name!r} contains {col.null_count} null(s); filter "
                f"them first (e.g. df.dropna({name!r}))")
        pytype = col.type
        if pa.types.is_list(pytype) or pa.types.is_fixed_size_list(pytype):
            dtype = pytype.value_type.to_pandas_dtype()
            chunks = (col.chunks if isinstance(col, pa.ChunkedArray)
                      else [col])
            parts = []
            for arr in chunks:  # per chunk: no combine_chunks 2GB overflow
                if len(arr) == 0:
                    continue
                if arr.flatten().null_count:
                    # inner nulls: keep the row path's loud semantics
                    # (TypeError for ints; the buffer path would smuggle
                    # them through as INT64_MIN/NaN)
                    parts.append(np.asarray(arr.to_pylist(), dtype=dtype))
                    continue
                if pa.types.is_fixed_size_list(pytype):
                    width = pytype.list_size
                else:
                    widths = np.diff(np.asarray(arr.offsets))
                    if not (widths == widths[0]).all():
                        # ragged rows: numpy row path (raises like np.stack)
                        parts.append(np.asarray(arr.to_pylist(),
                                                dtype=dtype))
                        continue
                    width = int(widths[0])
                flat = arr.flatten().to_numpy(zero_copy_only=False)
                parts.append(np.ascontiguousarray(flat).reshape(
                    -1, width).astype(dtype, copy=False))
            if not parts:
                # empty column: match the old to_pylist path's (0,) shape
                # when the row width is unknowable; fixed-size lists keep
                # their declared width
                if pa.types.is_fixed_size_list(pytype):
                    return np.zeros((0, pytype.list_size), dtype=dtype)
                return np.zeros((0,), dtype=dtype)
            out = parts[0] if len(parts) == 1 else np.vstack(parts)
            if not out.flags.writeable:
                # zero-copy view over the Arrow buffer: hand out a fresh
                # array (the old row path always did), so caller mutation
                # can neither raise nor write through to the table
                out = out.copy()
            return out
        return col.to_numpy(zero_copy_only=False)

    # -- batch protocol ----------------------------------------------------
    def iter_batches(self, batch_size: Optional[int] = None) -> Iterator[pa.RecordBatch]:
        """Iterate record batches; respects existing chunking unless a
        ``batch_size`` re-slicing is requested."""
        if batch_size is None:
            yield from self._table.to_batches()
        else:
            yield from self._table.to_batches(max_chunksize=batch_size)

    def map_blocks(self, fn: Callable[[pa.RecordBatch], pa.RecordBatch],
                   batch_size: int = 1024) -> "DataFrame":
        """Block-wise map: ``fn`` receives one arrow RecordBatch at a time
        and returns a RecordBatch (column layout may change).

        The vectorized counterpart of the reference's TensorFrames
        ``map_blocks`` executor path (``tensorframes.map_blocks`` —
        SURVEY.md §2 C11 ``blocked=True``): no per-row Python objects —
        ``fn`` works on columnar data.  Per-output-batch schemas are
        PROMOTED (null -> concrete, int -> float, missing column ->
        null-filled) exactly like ``map_rows`` — a later batch whose fn
        output widens a column must widen the frame, not raise (or
        truncate) against a schema pinned by the first batch."""
        out: List[pa.Table] = []
        schema: Optional[pa.Schema] = None
        for rb in self.iter_batches(batch_size):
            res = fn(rb)
            if not isinstance(res, pa.RecordBatch):
                raise TypeError(
                    f"map_blocks fn must return a pyarrow.RecordBatch, got "
                    f"{type(res).__name__}")
            t = pa.Table.from_batches([res])
            schema = _promote_schema(schema, t)
            out.append(t)
        if schema is None:
            return DataFrame.from_rows([])
        return DataFrame(_concat_conforming(out, schema))

    def map_rows(self, fn: Callable[[Row], dict],
                 batch_size: int = 1024,
                 materialize: bool = False) -> "DataFrame":
        """Row-wise map producing a new frame (host-side; used for cheap
        struct manipulation like resize UDFs, never for model compute).

        Processed BATCH-WISE: rows of one record batch are materialized,
        mapped, and converted back to arrow before the next batch is
        touched — peak Python-object residency is O(batch_size), not the
        table.  Each batch's schema is inferred INDEPENDENTLY and the
        running schema is promoted (null -> concrete, int -> float, ...)
        via ``unify_schemas`` whenever a later batch widens a column —
        matching the old whole-table inference.  (Building later batches
        directly against the pinned schema would silently TRUNCATE, e.g.
        float 3.5 -> int 3, because ``from_pylist(schema=...)`` coerces
        without raising.)

        Struct columns (e.g. image structs) are read ZERO-COPY: ``fn``
        receives dict views over the Arrow buffers (binary children as
        ``memoryview`` — wrap with ``bytes()`` if needed), and a struct
        the fn returns untouched is re-emitted without a Python->Arrow
        round trip, so mapping scalar columns next to an image column no
        longer pays per-row image materialization.

        ``materialize=True`` opts OUT of the zero-copy struct views and
        restores plain ``to_pylist`` dicts — binary struct children come
        back as real ``bytes`` instead of ``memoryview`` — for
        compatibility-sensitive row fns (``.decode()``, use as dict keys,
        pickling) at the old per-row materialization cost."""
        out_tables: List[pa.Table] = []
        schema: Optional[pa.Schema] = None
        for rb in self.iter_batches(batch_size):
            n = rb.num_rows
            if n == 0:
                continue
            col_rows: Dict[str, list] = {}
            for j, name in enumerate(rb.schema.names):
                a = rb.column(j)
                views = (_struct_view_rows(a)
                         if pa.types.is_struct(a.type) and not materialize
                         else None)
                col_rows[name] = (views if views is not None
                                  else a.to_pylist())
            names = rb.schema.names
            mapped = [fn(Row({nm: col_rows[nm][i] for nm in names}))
                      for i in range(n)]
            keys: List[str] = []
            for m in mapped:
                for k in m:
                    if k not in keys:
                        keys.append(k)
            pass_cols = {
                k: src for k in keys
                if (src := _passthrough_source(
                    [m.get(k) for m in mapped])) is not None}
            if len(pass_cols) < len(keys):
                t_plain = pa.Table.from_pylist(
                    [{k: v for k, v in m.items() if k not in pass_cols}
                     for m in mapped])
                t = pa.table(
                    [pass_cols[k] if k in pass_cols else t_plain.column(k)
                     for k in keys], names=keys)
            else:
                t = pa.table(list(pass_cols.values()),
                             names=list(pass_cols))
            schema = _promote_schema(schema, t)
            out_tables.append(t)
        if schema is None:
            return DataFrame.from_rows([])
        return DataFrame(_concat_conforming(out_tables, schema))
